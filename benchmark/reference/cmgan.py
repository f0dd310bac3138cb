"""The plain reference of CMGAN's generator (TSCNet) and its serving
recipe: float32 PyTorch, nothing else, written from upstream's code
(ruizhecao96/CMGAN, `src/models/generator.py`, `src/models/conformer.py`
and `src/evaluation.py`; Cao, Abdulatif and Yang, Interspeech 2022).

The modules, their order and their parameters' names are upstream's, so
a state dict of upstream's TSCNet loads here and into the program alike.
Departures, none of which changes an answer in float32:
  * einops' `rearrange` is written as views and permutes, and the
    conformer's two `Rearrange` layers as `Transpose`;
  * the attention runs one head at a time (upstream's einsums, including
    the one over `rel_pos_emb(dist)`, per head), so that the scores of a
    16 s utterance fit on one card;
  * `operands(dtype)` rounds the operands of every convolution, linear
    layer and attention product to a lower type (the control of a bf16
    program: fp8 e4m3, saturated at +-448), float32 elsewhere.
The width (`num_channel`), the bins (`num_features`), the number of
TSCBs, the heads and `max_pos_emb` are parameters, for the CPU tests'
small sizes; upstream's are 64, 201, 4, 4 and 512.

`enhance` is `evaluation.py`'s `enhance_one_track` on a waveform: level
normalisation, padding to a multiple of the hop with the utterance's own
first samples, centred STFT with a periodic Hamming window, power-law
compression, the generator, decompression, iSTFT, the level undone, cut
to the input's length. One utterance at a time, unpadded; an utterance
longer than `cut_len` (upstream splits it into rows) is refused.

This file is kept equal, byte for byte, to `tests/cmgan_reference.py`.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

_OPERAND: List[Optional[torch.dtype]] = [None]
FP8_MAX = 448.0


@contextlib.contextmanager
def operands(dtype: Optional[torch.dtype]):
    """Round the operands of every product to `dtype` inside the block
    (None: float32)."""
    saved = _OPERAND[0]
    _OPERAND[0] = dtype
    try:
        yield
    finally:
        _OPERAND[0] = saved


def op(t: torch.Tensor) -> torch.Tensor:
    dtype = _OPERAND[0]
    if dtype is None:
        return t
    if dtype == torch.float8_e4m3fn:
        t = t.clamp(-FP8_MAX, FP8_MAX)
    return t.to(dtype).float()


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN and cuBLAS inside the block."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(op(x), op(self.weight), self.bias)


class Conv1d(nn.Conv1d):
    def forward(self, x):
        return self._conv_forward(op(x), op(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        return self._conv_forward(op(x), op(self.weight), self.bias)


# ------------------------------------------------------------- conformer


class Swish(nn.Module):
    def forward(self, x):
        return x * x.sigmoid()


class GLU(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, x):
        out, gate = x.chunk(2, dim=self.dim)
        return out * gate.sigmoid()


class Transpose(nn.Module):
    """einops' Rearrange("b n c -> b c n") and its inverse."""

    def forward(self, x):
        return x.transpose(1, 2)


class DepthWiseConv1d(nn.Module):
    def __init__(self, chan_in, chan_out, kernel_size, padding):
        super().__init__()
        self.padding = padding
        self.conv = Conv1d(chan_in, chan_out, kernel_size, groups=chan_in)

    def forward(self, x):
        return self.conv(F.pad(x, self.padding))


class Scale(nn.Module):
    def __init__(self, scale, fn):
        super().__init__()
        self.fn = fn
        self.scale = scale

    def forward(self, x):
        return self.fn(x) * self.scale


class PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim)

    def forward(self, x):
        return self.fn(self.norm(x))


class Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, dropout=0.0, max_pos_emb=512):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.to_q = Linear(dim, inner_dim, bias=False)
        self.to_kv = Linear(dim, inner_dim * 2, bias=False)
        self.to_out = Linear(inner_dim, dim)
        self.max_pos_emb = max_pos_emb
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        b, n, _ = x.shape
        q, k, v = (self.to_q(x), *self.to_kv(x).chunk(2, dim=-1))
        # "b n (h d) -> b h n d"
        q, k, v = (t.reshape(b, n, self.heads, -1).transpose(1, 2)
                   for t in (q, k, v))
        out = attend(q, k, v, self.rel_pos_emb.weight, self.max_pos_emb,
                     self.scale)
        return self.dropout(self.to_out(out))


def attend(q, k, v, emb, max_pos_emb, scale):
    """Upstream's attention of (b, h, n, d) q, k, v with the relative
    positions' (2M + 1, d) table `emb`, one head at a time -> (b, n, h d)."""
    b, h, n, _ = q.shape
    m = max_pos_emb
    seq = torch.arange(n, device=q.device)
    dist = (seq[:, None] - seq[None, :]).clamp(-m, m) + m
    rel_pos_emb = F.embedding(dist, emb).to(q)
    heads = []
    for i in range(h):
        qi, ki, vi = q[:, i], k[:, i], v[:, i]
        dots = torch.einsum("b i d, b j d -> b i j", op(qi), op(ki)) * scale
        pos_attn = torch.einsum("b n d, n r d -> b n r", op(qi),
                                op(rel_pos_emb)) * scale
        attn = (dots + pos_attn).softmax(dim=-1)
        heads.append(torch.einsum("b i j, b j d -> b i d", op(attn), op(vi)))
    # "b h n d -> b n (h d)"
    return torch.stack(heads, dim=2).reshape(b, n, -1)


class FeedForward(nn.Module):
    def __init__(self, dim, mult=4, dropout=0.0):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, dim * mult), Swish(),
                                 nn.Dropout(dropout), Linear(dim * mult, dim),
                                 nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class ConformerConvModule(nn.Module):
    def __init__(self, dim, expansion_factor=2, kernel_size=31, dropout=0.0):
        super().__init__()
        inner_dim = dim * expansion_factor
        pad = kernel_size // 2
        padding = (pad, pad - (kernel_size + 1) % 2)
        self.net = nn.Sequential(
            nn.LayerNorm(dim), Transpose(), Conv1d(dim, inner_dim * 2, 1),
            GLU(dim=1),
            DepthWiseConv1d(inner_dim, inner_dim, kernel_size, padding),
            nn.BatchNorm1d(inner_dim), Swish(), Conv1d(inner_dim, dim, 1),
            Transpose(), nn.Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class ConformerBlock(nn.Module):
    def __init__(self, dim, dim_head, heads, ff_mult=4,
                 conv_expansion_factor=2, conv_kernel_size=31,
                 attn_dropout=0.0, ff_dropout=0.0, conv_dropout=0.0,
                 max_pos_emb=512):
        super().__init__()
        self.ff1 = FeedForward(dim=dim, mult=ff_mult, dropout=ff_dropout)
        self.attn = Attention(dim=dim, dim_head=dim_head, heads=heads,
                              dropout=attn_dropout, max_pos_emb=max_pos_emb)
        self.conv = ConformerConvModule(dim, conv_expansion_factor,
                                        conv_kernel_size, conv_dropout)
        self.ff2 = FeedForward(dim=dim, mult=ff_mult, dropout=ff_dropout)
        self.attn = PreNorm(dim, self.attn)
        self.ff1 = Scale(0.5, PreNorm(dim, self.ff1))
        self.ff2 = Scale(0.5, PreNorm(dim, self.ff2))
        self.post_norm = nn.LayerNorm(dim)

    def forward(self, x):
        x = self.ff1(x) + x
        x = self.attn(x) + x
        x = self.conv(x) + x
        x = self.ff2(x) + x
        return self.post_norm(x)


# ------------------------------------------------------------- generator


class DilatedDenseNet(nn.Module):
    def __init__(self, depth=4, in_channels=64):
        super().__init__()
        self.depth = depth
        self.in_channels = in_channels
        self.pad = nn.ConstantPad2d((1, 1, 1, 0), value=0.0)
        self.twidth = 2
        self.kernel_size = (self.twidth, 3)
        for i in range(self.depth):
            dil = 2 ** i
            pad_length = self.twidth + (dil - 1) * (self.twidth - 1) - 1
            setattr(self, f"pad{i + 1}",
                    nn.ConstantPad2d((1, 1, pad_length, 0), value=0.0))
            setattr(self, f"conv{i + 1}",
                    Conv2d(self.in_channels * (i + 1), self.in_channels,
                           kernel_size=self.kernel_size, dilation=(dil, 1)))
            setattr(self, f"norm{i + 1}",
                    nn.InstanceNorm2d(in_channels, affine=True))
            setattr(self, f"prelu{i + 1}", nn.PReLU(self.in_channels))

    def forward(self, x):
        skip = x
        for i in range(self.depth):
            out = getattr(self, f"pad{i + 1}")(skip)
            out = getattr(self, f"conv{i + 1}")(out)
            out = getattr(self, f"norm{i + 1}")(out)
            out = getattr(self, f"prelu{i + 1}")(out)
            skip = torch.cat([out, skip], dim=1)
        return out


class DenseEncoder(nn.Module):
    def __init__(self, in_channel, channels=64):
        super().__init__()
        self.conv_1 = nn.Sequential(
            Conv2d(in_channel, channels, (1, 1), (1, 1)),
            nn.InstanceNorm2d(channels, affine=True), nn.PReLU(channels))
        self.dilated_dense = DilatedDenseNet(depth=4, in_channels=channels)
        self.conv_2 = nn.Sequential(
            Conv2d(channels, channels, (1, 3), (1, 2), padding=(0, 1)),
            nn.InstanceNorm2d(channels, affine=True), nn.PReLU(channels))

    def forward(self, x):
        return self.conv_2(self.dilated_dense(self.conv_1(x)))


class TSCB(nn.Module):
    def __init__(self, num_channel=64, heads=4, max_pos_emb=512):
        super().__init__()
        kw = dict(dim=num_channel, dim_head=num_channel // heads, heads=heads,
                  conv_kernel_size=31, attn_dropout=0.2, ff_dropout=0.2,
                  max_pos_emb=max_pos_emb)
        self.time_conformer = ConformerBlock(**kw)
        self.freq_conformer = ConformerBlock(**kw)

    def forward(self, x_in):
        b, c, t, f = x_in.size()
        x_t = x_in.permute(0, 3, 2, 1).contiguous().view(b * f, t, c)
        x_t = self.time_conformer(x_t) + x_t
        x_f = x_t.view(b, f, t, c).permute(0, 2, 1, 3).contiguous().view(
            b * t, f, c)
        x_f = self.freq_conformer(x_f) + x_f
        return x_f.view(b, t, f, c).permute(0, 3, 1, 2)


class SPConvTranspose2d(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, r=1):
        super().__init__()
        self.pad1 = nn.ConstantPad2d((1, 1, 0, 0), value=0.0)
        self.out_channels = out_channels
        self.conv = Conv2d(in_channels, out_channels * r,
                           kernel_size=kernel_size, stride=(1, 1))
        self.r = r

    def forward(self, x):
        out = self.conv(self.pad1(x))
        batch_size, nchannels, h, w = out.shape
        out = out.view((batch_size, self.r, nchannels // self.r, h, w))
        out = out.permute(0, 2, 3, 4, 1)
        return out.contiguous().view((batch_size, nchannels // self.r, h, -1))


class MaskDecoder(nn.Module):
    def __init__(self, num_features, num_channel=64, out_channel=1):
        super().__init__()
        self.dense_block = DilatedDenseNet(depth=4, in_channels=num_channel)
        self.sub_pixel = SPConvTranspose2d(num_channel, num_channel, (1, 3), 2)
        self.conv_1 = Conv2d(num_channel, out_channel, (1, 2))
        self.norm = nn.InstanceNorm2d(out_channel, affine=True)
        self.prelu = nn.PReLU(out_channel)
        self.final_conv = Conv2d(out_channel, out_channel, (1, 1))
        self.prelu_out = nn.PReLU(num_features, init=-0.25)

    def forward(self, x):
        x = self.dense_block(x)
        x = self.sub_pixel(x)
        x = self.conv_1(x)
        x = self.prelu(self.norm(x))
        x = self.final_conv(x).permute(0, 3, 2, 1).squeeze(-1)
        return self.prelu_out(x).permute(0, 2, 1).unsqueeze(1)


class ComplexDecoder(nn.Module):
    def __init__(self, num_channel=64):
        super().__init__()
        self.dense_block = DilatedDenseNet(depth=4, in_channels=num_channel)
        self.sub_pixel = SPConvTranspose2d(num_channel, num_channel, (1, 3), 2)
        self.prelu = nn.PReLU(num_channel)
        self.norm = nn.InstanceNorm2d(num_channel, affine=True)
        self.conv = Conv2d(num_channel, 2, (1, 2))

    def forward(self, x):
        x = self.dense_block(x)
        x = self.sub_pixel(x)
        x = self.prelu(self.norm(x))
        return self.conv(x)


class TSCNet(nn.Module):
    def __init__(self, num_channel=64, num_features=201, num_tscb=4, heads=4,
                 max_pos_emb=512):
        super().__init__()
        self.num_tscb = num_tscb
        self.dense_encoder = DenseEncoder(in_channel=3, channels=num_channel)
        for i in range(num_tscb):
            setattr(self, f"TSCB_{i + 1}",
                    TSCB(num_channel, heads, max_pos_emb))
        self.mask_decoder = MaskDecoder(num_features, num_channel=num_channel,
                                        out_channel=1)
        self.complex_decoder = ComplexDecoder(num_channel=num_channel)

    def forward(self, x):
        mag = torch.sqrt(x[:, 0, :, :] ** 2 + x[:, 1, :, :] ** 2).unsqueeze(1)
        noisy_phase = torch.angle(
            torch.complex(x[:, 0, :, :], x[:, 1, :, :])).unsqueeze(1)
        x_in = torch.cat([mag, x], dim=1)

        out = self.dense_encoder(x_in)
        for i in range(self.num_tscb):
            out = getattr(self, f"TSCB_{i + 1}")(out)

        mask = self.mask_decoder(out)
        out_mag = mask * mag

        complex_out = self.complex_decoder(out)
        mag_real = out_mag * torch.cos(noisy_phase)
        mag_imag = out_mag * torch.sin(noisy_phase)
        final_real = mag_real + complex_out[:, 0, :, :].unsqueeze(1)
        final_imag = mag_imag + complex_out[:, 1, :, :].unsqueeze(1)
        return final_real, final_imag


def layout(model: nn.Module) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of every entry of `model`'s state dict, for a
    seeded draw: a conv's or linear layer's weight and bias ("uniform",
    fan_in), PyTorch's default bounds 1/sqrt(fan_in); an embedding
    ("normal",), N(0, 1); a norm's affine weight ("range", 0.5, 1.5) and
    bias ("range", -0.5, 0.5), and batch norm's running mean ("range",
    -0.5, 0.5) and variance ("range", 0.5, 1.5), so that no norm is the
    identity; a PReLU slope its default ("const", 0.25; -0.25 for the
    mask's per-bin slope), the step counter ("const", 0)."""
    out = []
    for prefix, mod in model.named_modules():
        own = list(mod.named_parameters(recurse=False)) + list(
            mod.named_buffers(recurse=False))
        for leaf, t in own:
            name = f"{prefix}.{leaf}" if prefix else leaf
            shape = tuple(t.shape)
            if isinstance(mod, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                w = mod.weight
                init = ("uniform", math.prod(w.shape[1:]))
            elif isinstance(mod, nn.Embedding):
                init = ("normal",)
            elif isinstance(mod, nn.PReLU):
                init = ("const", -0.25 if name.endswith("prelu_out.weight")
                        else 0.25)
            elif leaf == "num_batches_tracked":
                init = ("const", 0)
            elif leaf in ("weight", "running_var"):
                init = ("range", 0.5, 1.5)
            else:
                init = ("range", -0.5, 0.5)
            out.append((name, shape, init))
    return out


# ------------------------------------------------------------- serving


def hamming(n_fft: int, device) -> torch.Tensor:
    return torch.hamming_window(n_fft, periodic=True, device=device)


def power_compress(x: torch.Tensor, p: float = 0.3) -> torch.Tensor:
    """(..., 2) real/imag -> (B, 2, F, T) of the compressed magnitude at
    the same phase."""
    spec = torch.complex(x[..., 0], x[..., 1])
    mag, phase = torch.abs(spec) ** p, torch.angle(spec)
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], 1)


def power_uncompress(real: torch.Tensor, imag: torch.Tensor,
                     p: float = 0.3) -> torch.Tensor:
    spec = torch.complex(real, imag)
    mag, phase = torch.abs(spec) ** (1.0 / p), torch.angle(spec)
    return torch.stack([mag * torch.cos(phase), mag * torch.sin(phase)], -1)


@torch.no_grad()
def enhance(noisy: torch.Tensor, model: TSCNet, n_fft: int = 400,
            hop: int = 100, cut_len: int = 16000 * 16) -> torch.Tensor:
    """One utterance (L,) float32 -> its enhancement (L,), as
    `enhance_one_track`."""
    noisy = noisy[None]
    c = torch.sqrt(noisy.size(-1) / torch.sum(noisy ** 2.0, dim=-1))
    noisy = torch.transpose(noisy, 0, 1)
    noisy = torch.transpose(noisy * c, 0, 1)

    length = noisy.size(-1)
    frame_num = int(math.ceil(length / hop))
    padded_len = frame_num * hop
    padding_len = padded_len - length
    noisy = torch.cat([noisy, noisy[:, :padding_len]], dim=-1)
    if padded_len > cut_len:
        raise ValueError(f"{length} samples pass cut_len {cut_len}: "
                         "upstream splits such an utterance into rows")
    window = hamming(n_fft, noisy.device)
    noisy_spec = torch.view_as_real(torch.stft(
        noisy, n_fft, hop, window=window, onesided=True, return_complex=True))
    noisy_spec = power_compress(noisy_spec).permute(0, 1, 3, 2)
    est_real, est_imag = model(noisy_spec)
    est_real = est_real.permute(0, 1, 3, 2)
    est_imag = est_imag.permute(0, 1, 3, 2)

    est_spec_uncompress = power_uncompress(est_real, est_imag).squeeze(1)
    est_audio = torch.istft(torch.view_as_complex(est_spec_uncompress),
                            n_fft, hop, window=window, onesided=True)
    est_audio = est_audio / c
    return torch.flatten(est_audio)[:length]
