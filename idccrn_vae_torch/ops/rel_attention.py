"""Multi-head attention with Shaw's relative-position term, for serving
(no autograd): CMGAN's conformer attention.

    s_ij = (q_i . k_j + q_i . E[clip(i - j, -M, M) + M]) / sqrt(d)
    out_i = softmax_j(s_ij) v_j          (keys j < the row's key length)

q, k, v are (rows, heads, n, d) (any strides with d innermost), E is the
(2M + 1, d) embedding, `lengths` the (rows,) key lengths or None (every
key). The answer is (rows, heads, n, d) in q's dtype.

Two paths of one function:
  * `rel_attention_plain`: torch operations, blocked over queries so
    that a block's (rows, heads, block, n) scores are the largest tensor
    it makes; float32 inside. The CPU path, and the card test's yardstick.
  * `_rel_attention_cuda`: the CUDA kernel `rel_attn_fwd`
    (`idccrn_vae_torch/csrc/rel_attention.cu`; bf16, d = 16), the card's
    path: the wrapper `rel_attention` launches it for a CUDA tensor and
    never falls back. The source's header says what it replaces (no TPU
    kernel), what bounds it and how. `ops/cuda_library.py` builds it with
    nvcc at its first use and binds it with ctypes.

`COUNTERS["kernel_launches"]` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from idccrn_vae_torch.ops import cuda_library

COUNTERS = {"kernel_launches": 0}

# q, k, v, emb, out, lengths; their strides (rows, heads, n); rows, n,
# heads, maxpos; the scale; the stream
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 12
             + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])


def rel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  emb: torch.Tensor,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain path on the CPU."""
    if q.device.type == "cuda":
        return _rel_attention_cuda(q, k, v, emb, lengths)
    return rel_attention_plain(q, k, v, emb, lengths)


def rel_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        emb: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None,
                        block: int = 256) -> torch.Tensor:
    rows, heads, n, d = q.shape
    scale = d ** -0.5
    kf, vf = k.float(), v.float()
    pos = torch.arange(n, device=q.device)
    masked = None
    if lengths is not None:
        masked = (pos[None, :] >= lengths[:, None].to(pos.device))[
            :, None, None, :]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for i0 in range(0, n, block):
        qb = q[:, :, i0: i0 + block].float()
        s = qb @ kf.transpose(-1, -2)
        m = (emb.shape[0] - 1) // 2
        dist = (pos[i0: i0 + block, None] - pos[None, :]).clamp(-m, m) + m
        s = s + torch.einsum("rhqd,qkd->rhqk", qb, emb.float()[dist])
        s = s * scale
        if masked is not None:
            s = s.masked_fill(masked, float("-inf"))
        out[:, :, i0: i0 + block] = (s.softmax(-1) @ vf).to(q.dtype)
    return out


def _rel_attention_cuda(q, k, v, emb, lengths):
    rows, heads, n, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 \
                or t.device != q.device or t.stride(-1) != 1 \
                or t.data_ptr() % 16 or any(x % 8 for x in t.stride()[:3]):
            raise ValueError(
                f"{name}: {tuple(t.shape)} {t.dtype} stride {t.stride()} on "
                f"{t.device}; the kernel takes bf16 of q's shape and device, "
                "d innermost, 16-byte aligned rows")
    if d != 16:
        raise ValueError(f"the kernel takes heads of 16, got {d}")
    emb = emb.to(device=q.device, dtype=torch.bfloat16).contiguous()
    if emb.shape[1] != d or emb.shape[0] % 2 != 1:
        raise ValueError(f"embedding {tuple(emb.shape)} for d={d}")
    if lengths is not None:
        lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
        if lengths.shape != (rows,):
            raise ValueError(f"lengths {tuple(lengths.shape)}, want ({rows},)")
    out = torch.empty(rows, n, heads, d, dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    with torch.cuda.device(q.device):
        launch = cuda_library.function("rel_attention",
                                       "rel_attn_fwd_launch", _ARGTYPES)
        err = launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), emb.data_ptr(),
            out.data_ptr(), None if lengths is None else lengths.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], rows, n, heads, (emb.shape[0] - 1) // 2,
            d ** -0.5 * 1.4426950408889634,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"rel_attn_fwd: launch failed, CUDA error {err}")
    COUNTERS["kernel_launches"] += 1
    return out
