"""LSTM and complex LSTM: one CUDA kernel per layer on the card, an
eager step loop otherwise.

Mirrors `idccrn_vae_tpu/ops/lstm.py`:

  1. The input projections ``x @ W_ih^T`` for all timesteps are hoisted
     out of the recurrence into one batched matmul per layer.
  2. The complex LSTM's 4 reference passes (``re = lstm_re(xr) -
     lstm_im(xi)``, ``im = lstm_re(xi) + lstm_im(xr)``) run as ONE
     recurrence: the re/im weight sets are stacked on a leading axis
     (the JAX vmap) and the inputs [xr; xi] on the batch axis, so each
     step is a single (2, 2B, H) x (2, H, 4H) batched matmul.

Gate order is torch's (i, f, g, o). Weights use torch's LSTM layouts:
w_ih (4H, In), w_hh (4H, H), b_ih and b_hh (4H,).

Precision (bf16 compute): the JAX package keeps c in float32 and h in
the compute dtype, and its matmuls take reduced-precision operands with
float32 results. The port reproduces those rounding points: every
matmul runs on operands rounded to the compute dtype with exact products
and float32 sums (see ops/dense.py `rounded`), c stays float32, and each
h is rounded to the compute dtype. cuDNN's LSTM keeps neither split, so
it is not used.

The recurrence of a layer (`_layer`) takes one of two paths, by what it
is handed:
  * a CUDA tensor with nothing for autograd to record: the CUDA kernel
    `lstm_recurrence` (`csrc/lstm_recurrence.cu`, bf16 or float32, any
    N and T, H up to MAX_HIDDEN = 768), one launch a layer call, which
    never falls back. Its source's header says what it replaces, what
    bounds it and how. `ops/cuda_library.py` builds it at its first use.
    The repo's configurations are inside its H: zdim 128 gives 384, and
    768 with latent_num 2. A sliced latent's H is 3 zdim latent_num, so
    a zdim over 128 with two latents, or over 256 with one, raises here
    on the card with no grad; training runs it (the loop).
  * otherwise the eager step loop, the plain version: about 9 small ops
    a frame and a layer. The CPU runs it, and so do training, whose
    backward autograd replays step by step (the steps are collected and
    stacked instead of written into a preallocated output), and
    torch.export / torch.compile tracing, whose graph holds aten ops
    only.

`COUNTERS`: `kernel_launches`, the kernel's launches; `loop_steps`, the
steps the eager loop ran on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from idccrn_vae_torch.ops import cuda_library
from idccrn_vae_torch.ops.complex import csplit
from idccrn_vae_torch.ops.dense import rounded
from idccrn_vae_torch.ops.stft import _traced

Layer = Dict[str, torch.Tensor]
State = List[Tuple[torch.Tensor, torch.Tensor]]

COUNTERS = {"kernel_launches": 0, "loop_steps": 0}
# the kernel's element types, by the code its launcher takes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# dtype; xp, w_hh, h0, c0, out, c_final, barrier counters; sets, steps,
# rows, hidden, padded hidden; device; stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
# the largest hidden size the kernel takes: a block's rows of w_hh, all
# four gates, fit its shared memory at float32 and S = 2
MAX_HIDDEN = 768


def _layer(xp: torch.Tensor, w_hh: torch.Tensor, cdt: torch.dtype,
           carry: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """Run one layer's recurrence over precomputed input projections.

    xp: (S, T, N, 4H) float32, input matmul and both biases applied.
    w_hh: (S, 4H, H) float32 holding compute-dtype values.
    Returns outputs (S, T, N, H) at cdt and the final (h, c), c float32.
    """
    record = torch.is_grad_enabled() and any(
        t.requires_grad for t in (xp, w_hh, *(carry or ())))
    if xp.is_cuda and not record and not _traced():
        return _layer_cuda(xp, w_hh, cdt, carry)
    return _layer_plain(xp, w_hh, cdt, carry, record)


def _layer_plain(xp: torch.Tensor, w_hh: torch.Tensor, cdt: torch.dtype,
                 carry: Optional[Tuple[torch.Tensor, torch.Tensor]],
                 record: bool = False):
    """`_layer` as an eager step loop, the plain version of the kernel;
    with `record`, the steps are stacked for autograd."""
    s, t_len, n, h4 = xp.shape
    hid = h4 // 4
    whh_t = w_hh.transpose(1, 2)
    if carry is None:
        h = xp.new_zeros((s, n, hid))
        c = xp.new_zeros((s, n, hid))
    else:
        h, c = rounded(carry[0], cdt), carry[1].float()
    if xp.is_cuda:
        COUNTERS["loop_steps"] += t_len
    # autograd refuses out= arguments: with a graph to record, the steps
    # are collected and stacked (the same rounding points); without one,
    # each h is written straight into the output buffer
    out = None if record else torch.empty((s, t_len, n, hid), dtype=cdt,
                                          device=xp.device)
    # one view per step: the backward of unbind is one stack, where
    # indexing xp[:, t] would add a full-size gradient per step
    xs = xp.unbind(1)
    steps = []
    for t in range(t_len):
        gates = torch.baddbmm(xs[t], h, whh_t)
        i, f, _, o = torch.sigmoid(gates).chunk(4, dim=-1)
        g = torch.tanh(gates[..., 2 * hid : 3 * hid])
        c = torch.addcmul(f * c, i, g)
        if record:
            h_t = (o * torch.tanh(c)).to(cdt)
            steps.append(h_t)
        else:
            h_t = out[:, t]
            torch.mul(o, torch.tanh(c), out=h_t)
        h = h_t if cdt == torch.float32 else h_t.float()
    if record:
        out = torch.stack(steps, dim=1)
    return out, (out[:, -1], c)


def _layer_cuda(xp: torch.Tensor, w_hh: torch.Tensor, cdt: torch.dtype,
                carry: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """`_layer` in the CUDA kernel `lstm_recurrence`: the same inputs,
    outputs and rounding points; raises on what the kernel does not take."""
    s, t_len, n, h4 = xp.shape
    hid = h4 // 4
    if cdt not in _DTYPES:
        raise ValueError(f"the LSTM kernel computes in bf16 or float32, "
                         f"not {cdt}")
    if xp.dtype != torch.float32 or not xp.is_contiguous() or h4 % 4 \
            or t_len < 1 or n < 1 or not 1 <= hid <= MAX_HIDDEN:
        raise ValueError(f"xp {tuple(xp.shape)} {xp.dtype} stride "
                         f"{xp.stride()}: the kernel takes contiguous "
                         "float32 (S, T >= 1, N >= 1, 4H), H from 1 to "
                         f"{MAX_HIDDEN}")
    if w_hh.shape != (s, h4, hid) or w_hh.device != xp.device:
        raise ValueError(f"w_hh {tuple(w_hh.shape)} on {w_hh.device} for xp "
                         f"{tuple(xp.shape)} on {xp.device}")
    # rows of w_hh, h and out in whole 16-byte pieces
    piece = 16 // torch.empty((), dtype=cdt).element_size()
    hp = -(-hid // piece) * piece
    # exact: w_hh and the carried h hold compute-dtype values
    w = _padded(w_hh.to(cdt), hp)
    h0 = c0 = None
    if carry is not None:
        h0 = _padded(carry[0].to(device=xp.device, dtype=cdt), hp)
        c0 = carry[1].to(device=xp.device, dtype=torch.float32).contiguous()
        if h0.shape != (s, n, hp) or c0.shape != (s, n, hid):
            raise ValueError(f"carry {tuple(carry[0].shape)}, "
                             f"{tuple(c0.shape)}; want ({s}, {n}, {hid})")
    # the kernel reads h_{t-1} back from out, padding columns too
    out = (torch.empty if hp == hid else torch.zeros)(
        (s, t_len, n, hp), dtype=cdt, device=xp.device)
    c = torch.empty((s, n, hid), dtype=torch.float32, device=xp.device)
    stream = torch.cuda.current_stream(xp.device)
    with torch.cuda.device(xp.device):
        launch = cuda_library.function("lstm_recurrence",
                                       "lstm_recurrence_launch", _ARGTYPES)
        err = launch(_DTYPES[cdt], xp.data_ptr(), w.data_ptr(),
                     None if h0 is None else h0.data_ptr(),
                     None if c0 is None else c0.data_ptr(), out.data_ptr(),
                     c.data_ptr(), _barriers(stream, s).data_ptr(), s, t_len,
                     n, hid, hp, xp.device.index, stream.cuda_stream)
    if err:
        raise RuntimeError(f"lstm_recurrence: launch failed, CUDA error {err}")
    COUNTERS["kernel_launches"] += 1
    if hp != hid:
        out = out[..., :hid].contiguous()
    return out, (out[:, -1], c)


def _padded(t: torch.Tensor, hp: int) -> torch.Tensor:
    """t (..., H) contiguous from a 16-byte aligned address, with zero
    columns up to hp; t itself where it already is."""
    if t.shape[-1] == hp and t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    buf = t.new_zeros((*t.shape[:-1], hp))
    buf[..., : t.shape[-1]] = t
    return buf


_BARRIERS: Dict[Tuple[int, int], torch.Tensor] = {}


def _barriers(stream: torch.cuda.Stream, sets: int) -> torch.Tensor:
    """The kernel's step counters on `stream`: one a weight set and one
    more, zero between launches (each launch leaves them zero)."""
    key = (stream.device.index, stream.cuda_stream)
    buf = _BARRIERS.get(key)
    if buf is None or buf.numel() <= sets:
        buf = _BARRIERS[key] = torch.zeros(max(64, sets + 1),
                                           dtype=torch.int32,
                                           device=stream.device)
    return buf


def _stack_sets(sets: Sequence[Sequence[Layer]], k: int, name: str):
    return torch.stack([layers[k][name] for layers in sets])


def _lstm_sets(x: torch.Tensor, sets: Sequence[Sequence[Layer]],
               compute_dtype: Optional[torch.dtype], state: Optional[State]):
    """Multi-layer LSTMs of S weight sets over one shared input.

    x: (N, T, In). Returns last-layer outputs (S, T, N, H) at the
    compute dtype and the per-layer final (h, c), each (S, N, H).
    """
    cdt = torch.float32 if compute_dtype is None else compute_dtype
    n, t_len, _ = x.shape
    s = len(sets)
    # (T*N, In) rows, time-major so each step reads one contiguous block
    seq = rounded(x.transpose(0, 1).reshape(1, t_len * n, -1), cdt)
    seq = seq.expand(s, -1, -1)
    finals = []
    for k in range(len(sets[0])):
        w_ih = rounded(_stack_sets(sets, k, "w_ih"), cdt)
        w_hh = rounded(_stack_sets(sets, k, "w_hh"), cdt)
        bias = (_stack_sets(sets, k, "b_ih")
                + _stack_sets(sets, k, "b_hh")).float()
        xp = torch.baddbmm(bias[:, None], seq, w_ih.transpose(1, 2))
        carry = None if state is None else state[k]
        out, final = _layer(xp.view(s, t_len, n, -1), w_hh, cdt, carry)
        finals.append(final)
        seq = rounded(out.view(s, t_len * n, -1), cdt)
    return out, finals


def lstm(x: torch.Tensor, layers: Sequence[Layer],
         compute_dtype: Optional[torch.dtype] = None,
         state: Optional[State] = None, return_state: bool = False):
    """Multi-layer unidirectional LSTM, (B, T, In) -> (B, T, H) float32.

    state: optional list of per-layer (h, c), each (B, H).
    """
    st = None if state is None else [(h[None], c[None]) for h, c in state]
    out, finals = _lstm_sets(x, [layers], compute_dtype, st)
    result = out[0].transpose(0, 1).float()
    if return_state:
        return result, [(h[0], c[0]) for h, c in finals]
    return result


def complex_lstm(x: torch.Tensor, params: Dict[str, Sequence[Layer]],
                 compute_dtype: Optional[torch.dtype] = None,
                 state: Optional[State] = None, return_state: bool = False):
    """Complex LSTM over a cpack sequence (B, T, 2In) -> (B, T, 2H) float32.

    params: {"re": layers, "im": layers}. state: optional list of
    per-layer (h, c), each (2, 2B, H): weight set (re, im) first, then
    the stacked batch [xr; xi], as in the JAX package.
    """
    b = x.shape[0]
    re, im = csplit(x)
    xin = torch.cat([re, im], dim=0)  # (2B, T, In)
    out, finals = _lstm_sets(xin, [params["re"], params["im"]],
                             compute_dtype, state)
    out = out.float()  # (2, T, 2B, H); [0] = lstm_re, [1] = lstm_im
    out_re = out[0, :, :b] - out[1, :, b:]
    out_im = out[0, :, b:] + out[1, :, :b]
    result = torch.cat([out_re, out_im], dim=-1).transpose(0, 1).contiguous()
    if return_state:
        return result, finals
    return result
