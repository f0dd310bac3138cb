// Multi-head attention with Shaw's relative-position term, forward only,
// bf16 operands, float32 softmax and accumulation (CMGAN's conformer
// attention; the plain version is `rel_attention_plain` in
// idccrn_vae_torch/ops/rel_attention.py, which builds and binds this file).
//
//   s_ij  = (q_i . k_j + q_i . E[clip(i - j, -M, M) + M]) / sqrt(16)
//   out_i = softmax_j(s_ij) v_j        (j < the row's key length)
//
// It replaces no TPU kernel: the JAX package has no CMGAN. No torch
// operation computes a q-dependent relative term without the (rows,
// heads, n, n) scores and a second tensor of their size, 87 GB in float32
// at 8 x 101 rows of 2600 frames. Here no n x n tensor exists: a block of
// four warps owns 64 queries of one (row, head), each warp 16 of them,
// and walks the keys in tiles of 64 with an online softmax. The tile's K
// and the transposed V sit in shared memory; q . k, q . E and P v are
// m16n8k16 bf16 tensor-core products (mma.sync) whose float32 results
// stay in registers, the score fragment turning into P's operand
// fragment without a trip through memory.
//
// The relative term of a warp's tile is the product of its 16 queries
// with the 16 + 64 - 1 embedding rows that the tile's distances touch
// (clipped at +-M), written to the warp's shared buffer and read back
// along the tile's diagonals. A tile wholly beyond +-M adds one
// q . E[2M] (i - j >= M) or q . E[0] (i - j <= -M) a row, computed once.
//
// Bound: at d = 16 a score pair costs 96 FLOPs on the tensor cores and one
// exponential on the special-function unit (3.9e12/s against 989e12
// FLOP/s in bf16), so the exponentials bound it, near 38% of the FLOP
// roofline; one launch serves any n.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 16;           // head width
constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;  // queries a block
constexpr int BN = 64;          // keys a tile
constexpr int KP = D + 8;       // K tile's row pitch, bf16: conflict-free reads
constexpr int VP = BN + 8;      // transposed V tile's row pitch, bf16
constexpr int QEW = BN + 16;    // distances of a warp's tile: 16 + BN - 1, to 8
constexpr int QEP = QEW + 4;    // q . E buffer's row pitch, floats
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t NEG_INF = 0xff800000u;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float lo_f(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_f(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 out
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4 g + t. A: rows g and
// g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9. B: rows (k) 2t, 2t + 1 and
// 2t + 8, 2t + 9 of column g. C: rows g and g + 8, columns 2t, 2t + 1.
__global__ void __launch_bounds__(32 * WARPS) rel_attn_fwd(
    const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
    const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ E,
    __nv_bfloat16* __restrict__ O, const int* __restrict__ lens,
    int64_t sq_r, int64_t sq_h, int64_t sq_n, int64_t sk_r, int64_t sk_h,
    int64_t sk_n, int64_t sv_r, int64_t sv_h, int64_t sv_n, int64_t so_r,
    int64_t so_h, int64_t so_n, int n, int heads, int n_qb, int maxpos,
    float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[BN * KP];
  __shared__ __align__(16) __nv_bfloat16 vt[D * VP];
  __shared__ float qe_s[WARPS][16 * QEP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t bh = blockIdx.x / n_qb;
  const int i0 = (blockIdx.x % n_qb) * BM + warp * 16;  // the warp's queries
  const int64_t r = bh / heads;
  const int h = bh % heads;
  const int kv_len = lens ? lens[r] : n;
  const __nv_bfloat16* qp = Q + r * sq_r + h * sq_h;
  const __nv_bfloat16* kp = K + r * sk_r + h * sk_h;
  const __nv_bfloat16* vp = V + r * sv_r + h * sv_h;

  const int ra = i0 + g, rb = i0 + g + 8;
  uint32_t qa[4];
  qa[0] = ra < n ? ld32(qp + ra * sq_n + 2 * t) : 0u;
  qa[1] = rb < n ? ld32(qp + rb * sq_n + 2 * t) : 0u;
  qa[2] = ra < n ? ld32(qp + ra * sq_n + 2 * t + 8) : 0u;
  qa[3] = rb < n ? ld32(qp + rb * sq_n + 2 * t + 8) : 0u;

  // q . E[2M] and q . E[0] of rows g and g + 8, for tiles beyond +-M
  float far_l[2], far_r[2];
  {
    const __nv_bfloat16* el = E + (int64_t)2 * maxpos * D;
    for (int rr = 0; rr < 2; ++rr) {
      float sl = 0.f, sr = 0.f;
      for (int half = 0; half < 2; ++half) {
        const uint32_t w = qa[rr + 2 * half];
        const int d0 = 2 * t + 8 * half;
        sl += lo_f(w) * __bfloat162float(el[d0]) +
              hi_f(w) * __bfloat162float(el[d0 + 1]);
        sr += lo_f(w) * __bfloat162float(E[d0]) +
              hi_f(w) * __bfloat162float(E[d0 + 1]);
      }
      far_l[rr] = quad_sum(sl);
      far_r[rr] = quad_sum(sr);
    }
  }

  const float neg_inf = __uint_as_float(NEG_INF);
  float m_i[2] = {neg_inf, neg_inf}, l_i[2] = {0.f, 0.f};
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float* qe = qe_s[warp];

  for (int j0 = 0; j0 < kv_len; j0 += BN) {
    __syncthreads();  // the last tile's readers are done
    {
      // one 16-byte half row of K and of V a thread; V stored transposed
      const int key = tid >> 1, part = (tid & 1) * 8, j = j0 + key;
      uint4 kk = make_uint4(0u, 0u, 0u, 0u), vv = kk;
      if (j < kv_len) {
        kk = *reinterpret_cast<const uint4*>(kp + j * sk_n + part);
        vv = *reinterpret_cast<const uint4*>(vp + j * sv_n + part);
      }
      *reinterpret_cast<uint4*>(ks + key * KP + part) = kk;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(part + e) * VP + key] = ve[e];
    }
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const __nv_bfloat16* kr = ks + (nt * 8 + g) * KP + 2 * t;
      const uint32_t b[2] = {ld32(kr), ld32(kr + 8)};
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      mma(s[nt], qa, b);
    }

    const int dmin = i0 - j0 - (BN - 1);  // least i - j of the warp's tile
    if (dmin >= maxpos || i0 + 15 - j0 <= -maxpos) {
      const bool left = dmin >= maxpos;
      const float fg = left ? far_l[0] : far_r[0];
      const float fg8 = left ? far_l[1] : far_r[1];
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        s[nt][0] += fg;
        s[nt][1] += fg;
        s[nt][2] += fg8;
        s[nt][3] += fg8;
      }
    } else {
      // column c of q E_tile^T is distance dmin + c; score (row, col)
      // reads column row - col + BN - 1
#pragma unroll
      for (int ct = 0; ct < QEW / 8; ++ct) {
        const int dist =
            min(max(dmin + ct * 8 + g, -maxpos), maxpos) + maxpos;
        const __nv_bfloat16* er = E + dist * D + 2 * t;
        const uint32_t b[2] = {ld32(er), ld32(er + 8)};
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma(c, qa, b);
        float* row = qe + g * QEP + ct * 8 + 2 * t;
        row[0] = c[0];
        row[1] = c[1];
        row[8 * QEP] = c[2];
        row[8 * QEP + 1] = c[3];
      }
      __syncwarp();
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + 8 * (e >> 1), col = nt * 8 + 2 * t + (e & 1);
          s[nt][e] += qe[row * QEP + row - col + BN - 1];
        }
      __syncwarp();
    }

    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + nt * 8 + 2 * t + (e & 1);
        const float x = j < kv_len ? s[nt][e] * scale_log2 : neg_inf;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], ls[2] = {0.f, 0.f};
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = quad_max(mx[rr]);
      alpha[rr] = ex2(m_i[rr] - mx[rr]);
      m_i[rr] = mx[rr];
    }
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[nt][e] - m_i[e >> 1]);
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
    for (int rr = 0; rr < 2; ++rr) l_i[rr] = l_i[rr] * alpha[rr] + ls[rr];
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];

    // P v: the score fragments of key columns 16 kc .. 16 kc + 15 are the
    // A fragment of P
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc) {
      const uint32_t pa[4] = {pack(s[2 * kc][0], s[2 * kc][1]),
                              pack(s[2 * kc][2], s[2 * kc][3]),
                              pack(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const __nv_bfloat16* vr = vt + (dt * 8 + g) * VP + kc * 16 + 2 * t;
        const uint32_t b[2] = {ld32(vr), ld32(vr + 8)};
        mma(acc[dt], pa, b);
      }
    }
  }

  const float inv[2] = {1.f / quad_sum(l_i[0]), 1.f / quad_sum(l_i[1])};
  __nv_bfloat16* op = O + r * so_r + h * so_h;
#pragma unroll
  for (int dt = 0; dt < 2; ++dt) {
    if (ra < n)
      *reinterpret_cast<uint32_t*>(op + ra * so_n + dt * 8 + 2 * t) =
          pack(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (rb < n)
      *reinterpret_cast<uint32_t*>(op + rb * so_n + dt * 8 + 2 * t) =
          pack(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

}  // namespace

// The launch on `stream`, one block of 128 threads for each 64 queries of
// each (row, head); strides in elements. Returns the launch's CUDA error
// (0: none).
extern "C" int rel_attn_fwd_launch(
    const void* q, const void* k, const void* v, const void* emb, void* out,
    const void* lens, int64_t sq_r, int64_t sq_h, int64_t sq_n, int64_t sk_r,
    int64_t sk_h, int64_t sk_n, int64_t sv_r, int64_t sv_h, int64_t sv_n,
    int64_t so_r, int64_t so_h, int64_t so_n, int rows, int n, int heads,
    int maxpos, float scale_log2, void* stream) {
  const int n_qb = (n + BM - 1) / BM;
  const int64_t blocks = (int64_t)n_qb * rows * heads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  if (blocks == 0) return 0;
  rel_attn_fwd<<<(unsigned)blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (const __nv_bfloat16*)emb,
      (__nv_bfloat16*)out, (const int*)lens, sq_r, sq_h, sq_n, sk_r, sk_h,
      sk_n, sv_r, sv_h, sv_n, so_r, so_h, so_n, n, heads, n_qb, maxpos,
      scale_log2);
  return (int)cudaGetLastError();
}
