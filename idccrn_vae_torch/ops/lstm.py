"""LSTM and complex LSTM as an eager step loop.

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
matmul runs in float32 on operands rounded to the compute dtype (exact
products, see ops/dense.py `rounded`), c stays float32, and each h is
written to an output buffer of the compute dtype, which rounds it.
cuDNN's LSTM keeps neither split, so it is not used.

Each step launches about 9 small device ops (the GEMM, the copy of its
bias operand, the gates and the state update, and at bf16 the cast of
h); at 481 frames and 2 layers that is ~9,000 launches per forward, the
host-bound part of the serving path (PERF.md). When autograd records
(training), the steps are collected and stacked instead of written into
a preallocated output, and the backward replays the loop step by step.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from idccrn_vae_torch.ops.complex import csplit
from idccrn_vae_torch.ops.dense import rounded

Layer = Dict[str, torch.Tensor]
State = List[Tuple[torch.Tensor, torch.Tensor]]


def _layer(xp: torch.Tensor, w_hh: torch.Tensor, cdt: torch.dtype,
           carry: Optional[Tuple[torch.Tensor, torch.Tensor]]):
    """Run one layer's recurrence over precomputed input projections.

    xp: (S, T, N, 4H) float32, input matmul and both biases applied.
    w_hh: (S, 4H, H) float32 holding compute-dtype values.
    Returns outputs (S, T, N, H) at cdt and the final (h, c).
    """
    s, t_len, n, h4 = xp.shape
    hid = h4 // 4
    whh_t = w_hh.transpose(1, 2)
    if carry is None:
        h = xp.new_zeros((s, n, hid))
        c = xp.new_zeros((s, n, hid))
    else:
        h, c = rounded(carry[0], cdt), carry[1].float()
    # autograd refuses out= arguments: with a graph to record, the steps
    # are collected and stacked (the same rounding points); without one,
    # each h is written straight into the output buffer
    record = torch.is_grad_enabled() and (
        xp.requires_grad or w_hh.requires_grad or h.requires_grad
        or c.requires_grad)
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
