"""Shared DCCRN building blocks: parameter modules and the stage stacks.

Mirrors `idccrn_vae_tpu/models/modules.py` (encoder/decoder stages of
conv -> complex BN -> PReLU, the bottleneck reshapes, datanorm and the
mask reconstruction) in cpack layout (B, F, T, 2C).

The parameter modules carry the reference's state_dict names
(``encoders.{i}.conv.conv_re.weight``, ``encoders.{i}.bn.Vrr``,
``lstms.0.lstm_re.weight_ih_l{k}``, ``dense.linear_read.weight``,
``decoders.{i}.transconv.tconv_re.weight``, ...) and torch's weight
layouts, so reference checkpoints load as they are and the JAX
package's `torch_import` reads a port state_dict back into JAX
variables. Their initialisation follows the JAX package's init
functions (fan-in uniform bounds, gamma_ri ~ N(0, 1), PReLU 0.25),
drawn from an explicit CPU `torch.Generator` so that one seed gives the
same weights on every device.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from idccrn_vae_torch.models.config import (
    DccrnConfig,
    decoder_plan,
    encoder_plan,
)
from idccrn_vae_torch.ops.batchnorm import (
    complex_batch_norm,
    complex_batch_norm_train,
)
from idccrn_vae_torch.ops.conv import complex_conv2d, complex_conv_transpose2d
from idccrn_vae_torch.ops.dense import complex_dense
from idccrn_vae_torch.ops.lstm import complex_lstm
from idccrn_vae_torch.utils.profiling import span


def default_generator(generator: Optional[torch.Generator]) -> torch.Generator:
    """The CPU generator that initialises weights (seed 0 by default)."""
    return generator if generator is not None else torch.Generator(
    ).manual_seed(0)


def _uniform(shape, fan_in: int, gen: torch.Generator) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    w = torch.rand(shape, generator=gen) * (2 * bound) - bound
    return nn.Parameter(w)


class WeightBias(nn.Module):
    """One real conv / linear's weight and bias (never called itself)."""

    def __init__(self, w_shape, b_shape, fan_in: int, gen: torch.Generator):
        super().__init__()
        self.weight = _uniform(w_shape, fan_in, gen)
        self.bias = _uniform(b_shape, fan_in, gen)


class ComplexConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 gen: torch.Generator):
        super().__init__()
        kh, kw = kernel
        fan_in = cin * kh * kw
        self.conv_re = WeightBias((cout, cin, kh, kw), (cout,), fan_in, gen)
        self.conv_im = WeightBias((cout, cin, kh, kw), (cout,), fan_in, gen)


class ComplexConvTranspose2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: Sequence[int],
                 gen: torch.Generator):
        super().__init__()
        kh, kw = kernel
        fan_in = cout * kh * kw  # torch ConvTranspose2d convention
        self.tconv_re = WeightBias((cin, cout, kh, kw), (cout,), fan_in, gen)
        self.tconv_im = WeightBias((cin, cout, kh, kw), (cout,), fan_in, gen)


# JAX stats key -> ComplexBatchNorm buffer (the reference's names)
BN_STATS = {"mean_r": "running_mean_real", "mean_i": "running_mean_imag",
            "Vrr": "Vrr", "Vri": "Vri", "Vii": "Vii"}


class ComplexBatchNorm(nn.Module):
    """Complex BN parameters, running statistics and step counter.

    In train mode the forward whitens with the batch statistics and
    updates the running ones in place (`ops/batchnorm.py`); in eval mode
    it whitens with the running ones. `count` is the JAX package's step
    counter (its copy rule: the first train batch replaces the running
    statistics wholesale). It is a non-persistent buffer, so the
    state_dict keeps the reference's names and nothing else; the
    trainers save it beside the state_dict (`bn_counts`).

    With `update_stats` false (`frozen_bn_stats`), a train-mode forward
    still whitens with the batch statistics but leaves the running ones
    and the counter as they are: the JAX package's train-mode apply whose
    new statistics the caller discards.
    """

    def __init__(self, channels: int, gen: torch.Generator,
                 dis_mode: bool = False):
        super().__init__()
        c = channels
        self.dis_mode = dis_mode
        self.update_stats = True
        self.gamma_rr = nn.Parameter(torch.ones(c))
        self.gamma_ri = nn.Parameter(torch.randn(c, generator=gen))
        self.gamma_ii = nn.Parameter(torch.ones(c))
        self.beta_r = nn.Parameter(torch.zeros(c))
        self.beta_i = nn.Parameter(torch.zeros(c))
        # (1, C, 1, 1): the reference's buffer shape
        self.register_buffer("running_mean_real", torch.zeros(1, c, 1, 1))
        self.register_buffer("running_mean_imag", torch.zeros(1, c, 1, 1))
        self.register_buffer("Vrr", torch.ones(1, c, 1, 1))
        self.register_buffer("Vri", torch.zeros(1, c, 1, 1))
        self.register_buffer("Vii", torch.ones(1, c, 1, 1))
        self.register_buffer("count", torch.zeros((), dtype=torch.long),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = {k: getattr(self, k) for k in
                  ("gamma_rr", "gamma_ri", "gamma_ii", "beta_r", "beta_i")}
        stats = {k: getattr(self, name) for k, name in BN_STATS.items()}
        if not self.training:
            return complex_batch_norm(x, params, stats)
        out, new = complex_batch_norm_train(
            x, params, dict(stats, count=self.count), dis_mode=self.dis_mode)
        if self.update_stats:
            for k, name in dict(BN_STATS, count="count").items():
                getattr(self, name).copy_(new[k])
        return out


@contextlib.contextmanager
def frozen_bn_stats(*modules: nn.Module):
    """Inside the block, train-mode forwards of the ComplexBatchNorms in
    `modules` leave their running statistics and counters alone."""
    bns = [m for module in modules for m in module.modules()
           if isinstance(m, ComplexBatchNorm)]
    saved = [m.update_stats for m in bns]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m, s in zip(bns, saved):
            m.update_stats = s


def bn_counts(module: nn.Module) -> torch.Tensor:
    """The step counters of every ComplexBatchNorm in `module`, in module
    order, as one (N,) tensor on the CPU."""
    counts = [m.count for m in module.modules()
              if isinstance(m, ComplexBatchNorm)]
    return torch.stack(counts).cpu()


def set_bn_counts(module: nn.Module, counts) -> None:
    """Set the step counters of `module`'s ComplexBatchNorms (module
    order) from a sequence or a tensor of N integers, or from one integer
    for all of them."""
    bns = [m for m in module.modules() if isinstance(m, ComplexBatchNorm)]
    counts = torch.as_tensor(counts, dtype=torch.long).reshape(-1)
    if counts.numel() == 1:
        counts = counts.expand(len(bns))
    if counts.numel() != len(bns):
        raise ValueError(f"{counts.numel()} BN counters for {len(bns)} "
                         f"complex BN layers")
    with torch.no_grad():
        for m, n in zip(bns, counts):
            m.count.fill_(int(n))


class EncoderStage(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: DccrnConfig,
                 gen: torch.Generator, dis_mode: bool = False):
        super().__init__()
        self.conv = ComplexConv2d(cin, cout, cfg.kernel, gen)
        self.bn = ComplexBatchNorm(cout, gen, dis_mode)
        self.prelu = nn.PReLU()


class DecoderStage(nn.Module):
    def __init__(self, cin: int, cout: int, cfg: DccrnConfig,
                 gen: torch.Generator):
        super().__init__()
        self.transconv = ComplexConvTranspose2d(cin, cout, cfg.kernel, gen)
        self.bn = ComplexBatchNorm(cout, gen)
        self.prelu = nn.PReLU()


class LstmWeights(nn.Module):
    """torch nn.LSTM's parameters and names, without its cuDNN kernel."""

    def __init__(self, input_size: int, hidden: int, num_layers: int,
                 gen: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        for k in range(num_layers):
            in_sz = input_size if k == 0 else hidden
            for name, shape in (("weight_ih", (4 * hidden, in_sz)),
                                ("weight_hh", (4 * hidden, hidden)),
                                ("bias_ih", (4 * hidden,)),
                                ("bias_hh", (4 * hidden,))):
                self.register_parameter(f"{name}_l{k}",
                                        _uniform(shape, hidden, gen))

    def layers(self) -> List[dict]:
        return [{"w_ih": getattr(self, f"weight_ih_l{k}"),
                 "w_hh": getattr(self, f"weight_hh_l{k}"),
                 "b_ih": getattr(self, f"bias_ih_l{k}"),
                 "b_hh": getattr(self, f"bias_hh_l{k}")}
                for k in range(self.num_layers)]


class ComplexLSTM(nn.Module):
    def __init__(self, input_size: int, hidden: int, num_layers: int,
                 gen: torch.Generator):
        super().__init__()
        self.lstm_re = LstmWeights(input_size, hidden, num_layers, gen)
        self.lstm_im = LstmWeights(input_size, hidden, num_layers, gen)

    def forward(self, x, compute_dtype=None, state=None,
                return_state: bool = False):
        params = {"re": self.lstm_re.layers(), "im": self.lstm_im.layers()}
        with span("idccrn.lstm"):
            return complex_lstm(x, params, compute_dtype=compute_dtype,
                                state=state, return_state=return_state)


class ComplexDense(nn.Module):
    def __init__(self, cin: int, cout: int, gen: torch.Generator):
        super().__init__()
        self.linear_read = WeightBias((cout, cin), (cout,), cin, gen)
        self.linear_imag = WeightBias((cout, cin), (cout,), cin, gen)

    def forward(self, x, compute_dtype=None):
        return complex_dense(x, self.linear_read.weight,
                             self.linear_imag.weight, self.linear_read.bias,
                             self.linear_imag.bias, compute_dtype)


def build_encoder_stages(cfg: DccrnConfig, gen,
                         dis_mode: bool = False) -> nn.ModuleList:
    """dis_mode: the discriminator's BN, which copies every train batch's
    statistics in (`ops/batchnorm.py`)."""
    return nn.ModuleList(EncoderStage(cin, cout, cfg, gen, dis_mode)
                         for cin, cout in encoder_plan(cfg))


def build_decoder_stages(cfg: DccrnConfig, gen) -> nn.ModuleList:
    return nn.ModuleList(DecoderStage(cin, cout, cfg, gen)
                         for cin, cout in decoder_plan(cfg))


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Single-shared-alpha PReLU; alpha is cast to x's dtype so bf16
    activations stay bf16 (the JAX package does the same)."""
    return F.prelu(x, alpha.reshape(1).to(x.dtype))


# ---------------------------------------------------------------------------
# encoder / decoder stacks
# ---------------------------------------------------------------------------


def _stage_call(cfg: DccrnConfig, stage, st: nn.Module, *args):
    """stage(st, *args), and with cfg.remat under autograd, the JAX
    package's `jax.checkpoint` of the stage: its activations are dropped
    after the forward and recomputed in the backward. The recompute runs
    under `frozen_bn_stats`, so BN's running statistics and counter move
    once per forward; a train-mode BN's output depends on the batch
    statistics alone, not on the counter, so the recompute gives the
    forward's output whatever the counter now reads."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return stage(st, *args)
    return checkpoint(
        stage, st, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: (contextlib.nullcontext(), frozen_bn_stats(st)))


def apply_encoder_stack(stages: Sequence[EncoderStage], x: torch.Tensor,
                        cfg: DccrnConfig) -> Tuple[torch.Tensor, list]:
    """x: (B, F, T, 2*Cin) -> (bottleneck, skips list).

    BN runs in each stage's mode: batch statistics with a running update
    in train mode, the running statistics in eval mode. int8 quantizes a
    stage in eval mode only, as the JAX package's `not train`. cfg.remat
    recomputes each stage in the backward (`_stage_call`)."""
    time_pad = 1 if cfg.causal else 0
    cdt = cfg.compute_dtype

    def stage(st, x):
        c = st.conv
        x = complex_conv2d(x, c.conv_re.weight, c.conv_im.weight,
                           c.conv_re.bias, c.conv_im.bias, cfg.stride,
                           (cfg.freq_pad, time_pad), causal=cfg.causal,
                           compute_dtype=cdt,
                           quant=cfg.conv_quant and not st.training,
                           quant_min_ch=cfg.quant_min_ch)
        return prelu(st.bn(x), st.prelu.weight)

    skips = []
    for st in stages:
        x = _stage_call(cfg, stage, st, x)
        skips.append(x)
    return x, skips


def cpack_concat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Channel-concat two cpack maps: [a_re, b_re, a_im, b_im]."""
    ca, cb = a.shape[-1] // 2, b.shape[-1] // 2
    return torch.cat([a[..., :ca], b[..., :cb], a[..., ca:], b[..., cb:]],
                     dim=-1)


def _skip_kind(cfg: DccrnConfig, i: int, num_samples: int,
               pad_mode: str) -> str:
    """Eval-time skip handling of decoder stage i:
      'none'   — the stage has no skip channels
      'zero'   — skip channels are zeros: their conv adds nothing
      'shared' — the skip is identical across the S samples: its conv
                 runs once at batch B and the result is repeated
      'full'   — the skip already matches x's batch (S == 1)
    skip_mode 'prob' uses real skips at eval, as in the JAX package.
    """
    if cfg.skip_mode == "none" or i not in cfg.skip_to_use:
        return "none"
    if cfg.skip_mode == "zero" or (cfg.skip_mode == "runtime"
                                   and pad_mode == "zero"):
        return "zero"
    return "shared" if num_samples > 1 else "full"


def apply_decoder_stack(stages: Sequence[DecoderStage], x: torch.Tensor,
                        skips: Sequence[torch.Tensor], cfg: DccrnConfig,
                        num_samples: int = 1,
                        pad_mode: str = "sig",
                        skip_coin: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Decoder: x (B*S, F_bottleneck, T, 2C) -> (B*S, F0, T', 2).

    The skip concat cat([x, skip]) @ W runs as x @ W[:Cx] + skip @ W[Cx:]
    (two summed transposed convs), so the concatenated map is never
    materialised; W[Cx:] are the weight rows of the skip's channels.

    skip_coin: skip_mode 'prob' at train time, one 0-dim bool per
    forward (pvae_module.py:1731-1737): each skip stage takes the real
    skip, repeated over the samples, where it is true, and otherwise
    zeros (skip_prob 1) or a copy of the stage's own input (skip_prob 2).
    The choice is a `torch.where` on the device, as in the JAX package.
    """
    n = cfg.num_stages
    cdt = cfg.compute_dtype
    quant = (cfg.conv_quant and cfg.quant_scope == "all"
             and not any(st.training for st in stages))

    def tconv(inp, wr, wi, br=None, bi=None):
        # each half of a skip stage gates and scales on its own weights
        return complex_conv_transpose2d(inp, wr, wi, br, bi, cfg.stride,
                                        (cfg.freq_pad, 0), causal=cfg.causal,
                                        compute_dtype=cdt, quant=quant,
                                        quant_min_ch=cfg.quant_min_ch)

    def stage(st, x, skip, kind):
        t = st.transconv
        wr, wi = t.tconv_re.weight, t.tconv_im.weight
        br, bi = t.tconv_re.bias, t.tconv_im.bias
        if kind == "none":
            y = tconv(x, wr, wi, br, bi)
        else:
            cx = x.shape[-1] // 2
            y = tconv(x, wr[:cx], wi[:cx], br, bi)
            if kind == "shared":
                ys = tconv(skip, wr[cx:], wi[cx:])
                y = y + ys.repeat_interleave(num_samples, dim=0)
            elif kind == "full":
                y = y + tconv(skip, wr[cx:], wi[cx:])
            # 'zero': the skip half adds nothing
        return prelu(st.bn(y), st.prelu.weight)

    for i, st in enumerate(stages):
        kind = _skip_kind(cfg, i, num_samples, pad_mode)
        skip = None if kind in ("none", "zero") else skips[n - 1 - i]
        if kind != "none" and skip_coin is not None:
            rep = skips[n - 1 - i].repeat_interleave(num_samples, dim=0)
            alt = torch.zeros_like(rep) if cfg.skip_prob == 1 else x
            skip, kind = torch.where(skip_coin, rep, alt), "full"
        # the skip is an argument of the (rematerialized) stage, as in
        # the JAX package's jax.checkpoint(stage, static_argnums=(4,))
        x = _stage_call(cfg, stage, st, x, skip, kind)
    return x


# ---------------------------------------------------------------------------
# bottleneck reshapes (the reference's C-major CF flattening)
# ---------------------------------------------------------------------------


def flatten_bottleneck(x: torch.Tensor) -> torch.Tensor:
    """(B, F, T, 2C) cpack -> (B, T, 2*C*F) cpack sequence, index c*F + f
    (reshape(B, C*F, T) of the reference's (B, C, F, T) maps)."""
    b, f, t, c2 = x.shape
    c = c2 // 2
    return x.reshape(b, f, t, 2, c).permute(0, 2, 3, 4, 1).reshape(
        b, t, 2 * c * f)


def unflatten_bottleneck(x: torch.Tensor, c: int, f: int) -> torch.Tensor:
    """(B, T, 2*C*F) cpack sequence -> (B, F, T, 2C) cpack map."""
    b, t, _ = x.shape
    return x.reshape(b, t, 2, c, f).permute(0, 4, 1, 2, 3).reshape(
        b, f, t, 2 * c)


# ---------------------------------------------------------------------------
# spectrogram normalization + mask reconstruction
# ---------------------------------------------------------------------------


def apply_datanorm(stft_x: torch.Tensor, mean: torch.Tensor,
                   std: torch.Tensor) -> torch.Tensor:
    """Per-bin mean/std normalization, zeroing imag at DC and Nyquist.
    stft_x: (B, F, T, 2); mean/std: (F, 2)."""
    out = (stft_x - mean[None, :, None, :]) / (std[None, :, None, :] + 1e-6)
    out[:, 0, :, 1] = 0.0
    out[:, -1, :, 1] = 0.0
    return out


def undo_datanorm(spec: torch.Tensor, mean: torch.Tensor,
                  std: torch.Tensor) -> torch.Tensor:
    return std[None, :, None, :] * spec + mean[None, :, None, :]


def mask_reconstruct(mask: torch.Tensor, stft_x: torch.Tensor) -> torch.Tensor:
    """Polar bounded-magnitude mask: |Y| = |X| tanh(|M|), angle(Y) =
    angle(X) + angle(M). mask, stft_x: (B, F, T, 2)."""
    bounded = torch.tanh(torch.sqrt(mask[..., 0] ** 2 + mask[..., 1] ** 2))
    mask_phase = torch.atan2(mask[..., 1] / (bounded + 1e-8),
                             mask[..., 0] / (bounded + 1e-8))
    in_mag = torch.sqrt(stft_x[..., 0] ** 2 + stft_x[..., 1] ** 2)
    in_phase = torch.atan2(stft_x[..., 1], stft_x[..., 0])
    out_mag = in_mag * bounded
    phase = in_phase + mask_phase
    return torch.stack([out_mag * torch.cos(phase),
                        out_mag * torch.sin(phase)], dim=-1)
