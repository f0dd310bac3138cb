// The recurrence of one LSTM layer over all its frames, forward only, in
// one launch: S weight sets, each over the same N rows (the complex
// LSTM's re/im sets). The plain version is the eager step loop of
// `_layer` in idccrn_vae_torch/ops/lstm.py, which builds and binds this
// file and launches it for a CUDA tensor with nothing to record.
//
//   z_t = xp_t + h_{t-1} W_hh^T        gates (i, f, g, o), torch's order
//   c_t = sigmoid(f) c_{t-1} + sigmoid(i) tanh(g)
//   h_t = sigmoid(o) tanh(c_t), rounded to the element type
//
// xp holds every frame's input projection with both biases (one large
// product outside, torch.baddbmm). The rounding points are those of the
// JAX package's lax.scan (idccrn_vae_tpu/ops/lstm.py): the recurrent
// product takes operands of the element type with exact products and
// float32 sums (bf16: mma.sync m16n8k16 with float32 accumulation;
// float32: FFMA, not TF32), c stays float32, h is rounded to the element
// type before the next step reads it, and the gates use expf and tanhf.
//
// What it replaces: no TPU kernel at HEAD (the Pallas LSTM kernel was
// deleted in f3217b5); it replaces the JAX package's lax.scan recurrence.
// On the card the eager loop launched about 9 small ops a frame and a
// layer, and the card waited for the host between them.
//
// What bounds it: per step, the barrier across blocks and the exchange
// of h at small N; at large N the product, S N 4H H 2 FLOPs at 989.4
// TF/s against the bytes of w_hh, h and xp at 3.35 TB/s.
//
// What the design does about that:
//   * The grid splits over (weight set, block of 4 G hidden units). A
//     block loads the rows of w_hh of its units, all four gates, into
//     shared memory once and keeps them for the whole sequence; the
//     gates and the c update of its units stay in the block.
//   * Per step the only traffic is h: a block reads its rows of h_{t-1},
//     which is out[:, t-1] itself, through L2 (cp.async.cg, never L1:
//     L1 is not coherent across SMs) into shared memory, and writes its
//     units' h_t into out[:, t]. The first chunk's xp is loaded before
//     the barrier: it does not depend on h.
//   * One barrier per step among the blocks of one weight set: a counter
//     in device memory, raised by each block after its stores and read
//     with acquire semantics. The launch is cooperative, so every block
//     is resident or the launch is refused; the last block to finish
//     sets the counters back to zero for the next launch.
//   * A warp owns 4 hidden units and 16 rows: two n8 tiles, (i, f) and
//     (g, o) pairs, so that each lane holds the four gates of one unit
//     for two rows. A lane reads 16 contiguous bytes of h and of w_hh
//     for two k16 steps: A and B take the same permutation of k, so the
//     product is unchanged.
//   * One launch covers every row: they are walked in chunks of 16 WR
//     rows (WR warps along the rows), double-buffered where shared
//     memory allows. With one chunk (up to 64 rows, 16 where w_hh
//     fills shared memory) c stays in a register. With more, c lives in
//     the output c itself, each element read and written by one thread
//     only, and a chunk's xp and c load while the chunk before it
//     multiplies.
//   * The rows of w_hh, h and out are whole 16-byte pieces at 16-byte
//     aligned addresses (the wrapper pads H with zero columns where it
//     must), so every copy into shared memory is one cp.async of 16
//     bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAXWR = 4;   // warps along the rows
constexpr int KC = 32;     // columns of h per inner step: two k16 steps
constexpr int MAXTHREADS = 384;

struct Params {
  const float* xp;  // (S, T, N, 4H) float32
  const void* w;    // (S, 4H, HP) element type
  const void* h0;   // (S, N, HP) element type, or null: zeros
  const float* c0;  // (S, N, H) float32, or null: zeros
  void* out;        // (S, T, N, HP) element type
  float* cf;        // (S, N, H) float32: c, after the last step
  unsigned* sync;   // S step counters and one exit counter, all zero
  int steps, rows, hid, hp, groups, nb, wr, chunks, dbuf, kp, pitch;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until *counter reaches target; a barrier that some block never
// reaches within 10 s (a fault) ends the kernel with an error, not a hang.
__device__ __forceinline__ void wait_for(const unsigned* counter,
                                         unsigned target) {
  const uint64_t start = now_ns();
  unsigned seen;
  do {
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(seen)
                 : "l"(counter)
                 : "memory");
    if (seen < target && now_ns() - start > 10000000000ull) __trap();
  } while (seen < target);
}

// +1 on the counter, after (release) everything the block ordered before
// it with __syncthreads: its stores of h
__device__ __forceinline__ void arrive(unsigned* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
               : "memory");
}

// Rows row0 .. row0 + 16 WR of h (row stride HP) into dst (pitch
// p.pitch), zero past the rows and past HP; one cp.async group.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int row0,
                                      const Params& p) {
  constexpr int E = 16 / sizeof(T);
  const int n_rows = 16 * p.wr, per = p.kp / E;
  for (int i = threadIdx.x; i < n_rows * per; i += blockDim.x) {
    const int r = i / per, k = (i - r * per) * E, row = row0 + r;
    const bool ok = row < p.rows && k < p.hp;
    cp_async16(dst + r * p.pitch + k, ok ? src + (int64_t)row * p.hp + k : src,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

// c += a (16 x 16, row) b (16 x 8, col), bf16 in, float32 out
__device__ __forceinline__ void mma(float c[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[nt][e] = the warp's 16 rows of h (hs) times its 16 weight rows (ws):
// rows g (e < 2) and g + 8 (e >= 2), weight row 8 nt + 2 t + (e & 1); the
// C fragment of mma.m16n8k16 (lane = 4 g + t). A lane reads elements
// k + 8 t .. k + 8 t + 7 of its rows: elements 4 s + {0, 1} fill k-slots
// {2t, 2t + 1} of the k16 step s, 4 s + {2, 3} slots {2t + 8, 2t + 9}, for
// h and w_hh alike.
__device__ __forceinline__ void product(const __nv_bfloat16* hs,
                                        const __nv_bfloat16* ws, int pitch,
                                        int kp, int lane, float acc[2][4]) {
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* a_lo = hs + g * pitch + 8 * t;
  const __nv_bfloat16* a_hi = a_lo + 8 * pitch;
  const __nv_bfloat16* b_if = ws + g * pitch + 8 * t;
  const __nv_bfloat16* b_go = b_if + 8 * pitch;
  float part[2][2][4] = {};
  for (int k = 0; k < kp; k += KC) {
    const uint4 lo = *reinterpret_cast<const uint4*>(a_lo + k);
    const uint4 hi = *reinterpret_cast<const uint4*>(a_hi + k);
    const uint4 wi = *reinterpret_cast<const uint4*>(b_if + k);
    const uint4 wg = *reinterpret_cast<const uint4*>(b_go + k);
    mma(part[0][0], lo.x, hi.x, lo.y, hi.y, wi.x, wi.y);
    mma(part[0][1], lo.x, hi.x, lo.y, hi.y, wg.x, wg.y);
    mma(part[1][0], lo.z, hi.z, lo.w, hi.w, wi.z, wi.w);
    mma(part[1][1], lo.z, hi.z, lo.w, hi.w, wg.z, wg.w);
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = part[0][nt][e] + part[1][nt][e];
}

// The same fragment in float32 with FFMA: each lane's eight dot products
// in the order of k.
__device__ __forceinline__ void product(const float* hs, const float* ws,
                                        int pitch, int kp, int lane,
                                        float acc[2][4]) {
  const int g = lane >> 2, t = lane & 3;
  const float* a_lo = hs + g * pitch;
  const float* a_hi = a_lo + 8 * pitch;
  for (int k = 0; k < kp; k += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a_lo + k);
    const float4 y = *reinterpret_cast<const float4*>(a_hi + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          ws + (8 * (q >> 1) + 2 * t + (q & 1)) * pitch + k);
      float& s0 = acc[q >> 1][q & 1];
      float& s1 = acc[q >> 1][2 + (q & 1)];
      s0 = fmaf(x.x, v.x, s0);
      s0 = fmaf(x.y, v.y, s0);
      s0 = fmaf(x.z, v.z, s0);
      s0 = fmaf(x.w, v.w, s0);
      s1 = fmaf(y.x, v.x, s1);
      s1 = fmaf(y.y, v.y, s1);
      s1 = fmaf(y.z, v.z, s1);
      s1 = fmaf(y.w, v.w, s1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(MAXTHREADS) lstm_recurrence(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int E = 16 / sizeof(T);
  T* const ws = reinterpret_cast<T*>(smem);
  T* const hs = ws + 16 * p.groups * p.pitch;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int gi = warp % p.groups, wr = warp / p.groups;
  const int sets = gridDim.x / p.nb, set = blockIdx.x / p.nb;
  const int H = p.hid, chunk_rows = 16 * p.wr;
  const int j0 = (blockIdx.x - set * p.nb) * 4 * p.groups;
  const int j = j0 + 4 * gi + t;  // the lane's hidden unit
  const int64_t xt = (int64_t)p.rows * 4 * H, ot = (int64_t)p.rows * p.hp;

  // weight row 16 u + 8 nt + n: gate 2 nt + (n & 1) of unit j0 + 4 u + n / 2;
  // one cp.async group, which the first staged step's wait completes
  {
    const T* w = static_cast<const T*>(p.w) + (int64_t)set * 4 * H * p.hp;
    const int per = p.kp / E;
    for (int i = tid; i < 16 * p.groups * per; i += blockDim.x) {
      const int r = i / per, k = (i - r * per) * E;
      const int unit = j0 + 4 * (r >> 4) + ((r & 7) >> 1);
      const int gate = 2 * ((r >> 3) & 1) + (r & 1);
      const bool ok = unit < H && k < p.hp;
      cp_async16(ws + r * p.pitch + k,
                 ok ? w + (int64_t)(gate * H + unit) * p.hp + k : w,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  }

  const float* const xp = p.xp + set * p.steps * xt;
  T* const out = static_cast<T*>(p.out) + set * p.steps * ot;
  const T* const h0 =
      p.h0 ? static_cast<const T*>(p.h0) + set * ot : nullptr;
  const float* const c0 = p.c0 ? p.c0 + (int64_t)set * p.rows * H : nullptr;
  float* const cf = p.cf + (int64_t)set * p.rows * H;
  unsigned* const count = p.sync + set;
  auto buf = [&](int ch) {
    return hs + (p.dbuf ? (ch & 1) : 0) * chunk_rows * p.pitch;
  };
  // xp (the four gates) and c of the lane's two rows of chunk ch at step
  auto fetch = [&](int step, int ch, float x[2][4], float c[2]) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = ch * chunk_rows + 16 * wr + g + 8 * rr;
      const bool ok = row < p.rows && j < H;
      const float* src = xp + step * xt + (int64_t)row * 4 * H + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) x[rr][q] = ok ? __ldg(src + q * H) : 0.f;
      const float* c_src = step ? cf : c0;
      c[rr] = ok && c_src ? c_src[row * H + j] : 0.f;
    }
  };

  float x[2][4], c[2];
  fetch(0, 0, x, c);
  for (int step = 0; step < p.steps; ++step) {
    const T* src = h0;
    if (step > 0) {
      src = out + (step - 1) * ot;
      if (tid == 0) wait_for(count, (unsigned)p.nb * step);
      __syncthreads();
    }
    T* const dst = out + step * ot;
    if (src) stage(buf(0), src, 0, p);
    for (int ch = 0; ch < p.chunks; ++ch) {
      // the next chunk's xp and c, in the order of the loop, load under
      // this chunk's product; with one chunk, c stays in the register
      const bool last = ch + 1 == p.chunks;
      float xn[2][4], cn[2];
      if (!last)
        fetch(step, ch + 1, xn, cn);
      else if (step + 1 < p.steps)
        fetch(step + 1, 0, xn, cn);
      float acc[2][4] = {};
      if (src) {
        if (p.dbuf && !last) {
          stage(buf(ch + 1), src, (ch + 1) * chunk_rows, p);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        product(buf(ch) + 16 * wr * p.pitch, ws + 16 * gi * p.pitch, p.pitch,
                p.kp, lane, acc);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int row = ch * chunk_rows + 16 * wr + g + 8 * rr;
        if (row < p.rows && j < H) {
          const float zi = x[rr][0] + acc[0][2 * rr];
          const float zf = x[rr][1] + acc[0][2 * rr + 1];
          const float zg = x[rr][2] + acc[1][2 * rr];
          const float zo = x[rr][3] + acc[1][2 * rr + 1];
          c[rr] = sigmoid(zf) * c[rr] + sigmoid(zi) * tanhf(zg);
          dst[(int64_t)row * p.hp + j] = from_f<T>(sigmoid(zo) * tanhf(c[rr]));
          if (p.chunks > 1 || step + 1 == p.steps) cf[row * H + j] = c[rr];
        }
      }
      if (src && !last) {
        __syncthreads();  // the chunk's buffer is free again
        if (!p.dbuf) stage(buf(ch + 1), src, (ch + 1) * chunk_rows, p);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
        for (int q = 0; q < 4; ++q) x[rr][q] = xn[rr][q];
        if (p.chunks > 1) c[rr] = cn[rr];
      }
    }
    __syncthreads();  // every h_t of the block is stored, every buffer free
    if (tid == 0) arrive(count);
  }

  cp_async_wait<0>();  // a single step from zeros never waited for w_hh
  if (tid == 0) {
    // after its last arrival (release), before the resets (acquire)
    unsigned done;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(done)
                 : "l"(p.sync + sets)
                 : "memory");
    if (done == gridDim.x - 1) {  // every block is past its last barrier
      for (int s = 0; s <= sets; ++s) atomicExch(p.sync + s, 0u);
    }
  }
}

template <typename T>
int launch(const float* xp, const void* w, const void* h0, const float* c0,
           void* out, float* cf, unsigned* sync, int sets, int steps,
           int rows, int hid, int hp, int device, cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  auto aligned = [](const void* q) {
    return reinterpret_cast<uintptr_t>(q) % 16 == 0;
  };
  if (hp < hid || hp % E) return (int)cudaErrorInvalidValue;
  if (!aligned(w) || !aligned(out) || (h0 && !aligned(h0)))
    return (int)cudaErrorMisalignedAddress;
  int sms = 0, smem_max = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (!err)
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err) return (int)err;
  // blocks of 4 G units, one block an SM per set where the units allow
  const int units = (hid + 3) / 4;
  const int per_set = sms / sets > 1 ? sms / sets : 1;
  const int groups = (units + per_set - 1) / per_set;
  const int nb = (units + groups - 1) / groups;
  const int kp = (hp + KC - 1) / KC * KC;
  // conflict-free 16-byte reads of neighbouring rows
  const int pitch = sizeof(T) == 2 ? kp + (kp * 2 % 128 ? 0 : 32) : kp + 4;
  int wr = (rows + 15) / 16 < MAXWR ? (rows + 15) / 16 : MAXWR;
  int chunks = 0, dbuf = 0;
  size_t smem = 0;
  for (;; wr /= 2) {
    chunks = (rows + 16 * wr - 1) / (16 * wr);
    const size_t weights = sizeof(T) * pitch * 16 * groups;
    const size_t chunk = sizeof(T) * pitch * 16 * wr;
    dbuf = chunks > 1 && weights + 2 * chunk <= (size_t)smem_max;
    smem = weights + (dbuf ? 2 : 1) * chunk;
    if (smem <= (size_t)smem_max || wr == 1) break;
  }
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  const int threads = 32 * groups * wr, blocks = sets * nb;
  if (threads > MAXTHREADS) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(lstm_recurrence<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_recurrence<T>, threads, smem);
  if (err) return (int)err;
  if ((int64_t)per_sm * sms < blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;

  Params p;
  p.xp = xp;
  p.w = w;
  p.h0 = h0;
  p.c0 = c0;
  p.out = out;
  p.cf = cf;
  p.sync = sync;
  p.steps = steps;
  p.rows = rows;
  p.hid = hid;
  p.hp = hp;
  p.groups = groups;
  p.nb = nb;
  p.wr = wr;
  p.chunks = chunks;
  p.dbuf = dbuf;
  p.kp = kp;
  p.pitch = pitch;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel((const void*)lstm_recurrence<T>,
                                    dim3(blocks), dim3(threads), args, smem,
                                    stream);
  if (!err) err = cudaGetLastError();
  return (int)err;
}

}  // namespace

// The recurrence of one layer on `stream`, in one launch: dtype 0
// bfloat16, 1 float32 for w, h0 and out. Every tensor is contiguous: xp
// (S, T, N, 4H) float32, w (S, 4H, HP), h0 (S, N, HP) or null, c0 (S, N,
// H) float32 or null, out (S, T, N, HP), cf (S, N, H) float32, sync S + 1
// zero counters. HP, the row length of w, h0 and out, is H or more and
// whole 16-byte pieces, their columns past H zero, and w, h0 and out
// start 16-byte aligned. Returns the first CUDA error (0: none).
extern "C" int lstm_recurrence_launch(int dtype, const void* xp,
                                      const void* w, const void* h0,
                                      const void* c0, void* out, void* cf,
                                      void* sync, int sets, int steps,
                                      int rows, int hid, int hp, int device,
                                      void* stream) {
  if (sets < 1 || steps < 1 || rows < 1 || hid < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  auto run = dtype == 0 ? launch<__nv_bfloat16> : launch<float>;
  return run((const float*)xp, w, h0, (const float*)c0, out, (float*)cf,
             (unsigned*)sync, sets, steps, rows, hid, hp, device,
             (cudaStream_t)stream);
}
