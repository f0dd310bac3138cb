"""CMGAN's generator, TSCNet, for serving (Cao, Abdulatif and Yang,
"CMGAN: Conformer-based Metric GAN for Speech Enhancement", Interspeech
2022; ruizhecao96/CMGAN `src/models/generator.py`, `conformer.py`).

The module tree and its parameters' names are upstream's, so that a
state dict of upstream's TSCNet loads as it is; the modules only hold
the parameters. `forward` is written out below with three masks, so that
a padded row's answer is the answer of its utterance alone: each
InstanceNorm's statistics over the row's real frames, the time
attention's keys up to the row's length, and the conformer conv's
depthwise input zeroed past it. The dilated dense blocks are causal in
time and the frequency conformer works within one frame, so nothing else
needs one.

  x (B, 2, T, F) compressed spectrum, frames (B,) real frame counts
  -> DenseEncoder: 1x1 conv 3 -> C, DilatedDenseNet (kernel (2, 3), time
     dilations 1, 2, 4, 8, causal), (1, 3) stride (1, 2) conv F -> F'
     (each conv: InstanceNorm2d (affine), PReLU)
  -> TSCBs: a time conformer over the B F' rows of T frames, then a
     frequency conformer over the B T rows of F' bins, each with a
     residual around it; a conformer: half-step FFN (x4, Swish), Shaw
     relative-position attention (`ops/rel_attention.py`), the conv
     module (LayerNorm, 1x1 C -> 4C, GLU, depthwise 31, BatchNorm1d,
     Swish, 1x1 2C -> C), half-step FFN, LayerNorm
  -> MaskDecoder (dense block, sub-pixel conv r=2, (1, 2) conv,
     InstanceNorm, PReLU, 1x1 conv, per-bin PReLU) times |x|, at the
     noisy phase, plus the ComplexDecoder (dense block, sub-pixel conv,
     InstanceNorm, PReLU, (1, 2) conv to 2 channels).

Precision (`prepare(dtype)`): convolutions, linear layers and attention
take `dtype` operands (bf16 on the card) with float32 accumulation, and
activations are stored in it; the norms' statistics, the softmax, the
magnitude and phase (sqrt, atan2, cos, sin) are float32. In eval,
BatchNorm1d with its running statistics is folded into the depthwise
conv before it, and the FFNs' half step into their second linear.
Dropout is off.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from idccrn_vae_torch.ops.rel_attention import rel_attention
from idccrn_vae_torch.utils.profiling import span

_CL = torch.channels_last


# ------------------------------------------------- parameter containers


class _FeedForward(nn.Module):
    def __init__(self, dim, mult):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(dim, dim * mult), nn.Identity(),
                                 nn.Identity(), nn.Linear(dim * mult, dim),
                                 nn.Identity())


class _PreNorm(nn.Module):
    def __init__(self, dim, fn):
        super().__init__()
        self.fn = fn
        self.norm = nn.LayerNorm(dim)


class _Scale(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn


class _Attention(nn.Module):
    def __init__(self, dim, heads, dim_head, max_pos_emb):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(dim, dim_head * heads, bias=False)
        self.to_kv = nn.Linear(dim, dim_head * heads * 2, bias=False)
        self.to_out = nn.Linear(dim_head * heads, dim)
        self.rel_pos_emb = nn.Embedding(2 * max_pos_emb + 1, dim_head)


class _DepthWise(nn.Module):
    def __init__(self, chan, kernel):
        super().__init__()
        self.conv = nn.Conv1d(chan, chan, kernel, groups=chan)


class ConformerBlock(nn.Module):
    def __init__(self, dim, heads, max_pos_emb=512, ff_mult=4, expansion=2,
                 kernel=31):
        super().__init__()
        inner = dim * expansion
        self.kernel = kernel
        self.ff1 = _Scale(_PreNorm(dim, _FeedForward(dim, ff_mult)))
        self.attn = _PreNorm(dim, _Attention(dim, heads, dim // heads,
                                             max_pos_emb))
        self.conv = nn.Module()
        self.conv.net = nn.Sequential(
            nn.LayerNorm(dim), nn.Identity(), nn.Conv1d(dim, inner * 2, 1),
            nn.Identity(), _DepthWise(inner, kernel), nn.BatchNorm1d(inner),
            nn.Identity(), nn.Conv1d(inner, dim, 1), nn.Identity(),
            nn.Identity())
        self.ff2 = _Scale(_PreNorm(dim, _FeedForward(dim, ff_mult)))
        self.post_norm = nn.LayerNorm(dim)


class DilatedDenseNet(nn.Module):
    def __init__(self, depth, channels):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            setattr(self, f"conv{i + 1}",
                    nn.Conv2d(channels * (i + 1), channels, (2, 3),
                              dilation=(2 ** i, 1)))
            setattr(self, f"norm{i + 1}",
                    nn.InstanceNorm2d(channels, affine=True))
            setattr(self, f"prelu{i + 1}", nn.PReLU(channels))


def _conv_norm_prelu(cin, cout, kernel, stride=(1, 1), padding=(0, 0)):
    return nn.Sequential(nn.Conv2d(cin, cout, kernel, stride, padding),
                         nn.InstanceNorm2d(cout, affine=True),
                         nn.PReLU(cout))


class _SubPixel(nn.Module):
    def __init__(self, channels, r=2):
        super().__init__()
        self.r = r
        self.conv = nn.Conv2d(channels, channels * r, (1, 3))


class TSCNet(nn.Module):
    """Upstream's TSCNet at `num_channel` (64), `num_features` (201),
    `num_tscb` (4), `heads` (4) and `max_pos_emb` (512)."""

    def __init__(self, num_channel=64, num_features=201, num_tscb=4, heads=4,
                 max_pos_emb=512, device=None):
        super().__init__()
        c = num_channel
        self.num_tscb = num_tscb
        self.dense_encoder = nn.Module()
        self.dense_encoder.conv_1 = _conv_norm_prelu(3, c, (1, 1))
        self.dense_encoder.dilated_dense = DilatedDenseNet(4, c)
        self.dense_encoder.conv_2 = _conv_norm_prelu(c, c, (1, 3), (1, 2),
                                                     (0, 1))
        for i in range(num_tscb):
            tscb = nn.Module()
            tscb.time_conformer = ConformerBlock(c, heads, max_pos_emb)
            tscb.freq_conformer = ConformerBlock(c, heads, max_pos_emb)
            setattr(self, f"TSCB_{i + 1}", tscb)
        md = self.mask_decoder = nn.Module()
        md.dense_block = DilatedDenseNet(4, c)
        md.sub_pixel = _SubPixel(c)
        md.conv_1 = nn.Conv2d(c, 1, (1, 2))
        md.norm = nn.InstanceNorm2d(1, affine=True)
        md.prelu = nn.PReLU(1)
        md.final_conv = nn.Conv2d(1, 1, (1, 1))
        md.prelu_out = nn.PReLU(num_features, init=-0.25)
        cd = self.complex_decoder = nn.Module()
        cd.dense_block = DilatedDenseNet(4, c)
        cd.sub_pixel = _SubPixel(c)
        cd.prelu = nn.PReLU(c)
        cd.norm = nn.InstanceNorm2d(c, affine=True)
        cd.conv = nn.Conv2d(c, 2, (1, 2))
        self.dtype = torch.float32
        self.to(device)
        self.eval()

    @torch.no_grad()
    def prepare(self, dtype: torch.dtype = torch.float32) -> "TSCNet":
        """Cache each product's operands in `dtype` (call after loading
        weights)."""
        self.dtype = dtype
        # detached: `.to` of a parameter to its own type is the parameter,
        # which module assignment would register
        for mod in self.modules():
            if isinstance(mod, (nn.Conv2d, nn.Conv1d, nn.Linear)):
                w = mod.weight.detach().to(dtype)
                if w.dim() == 4:
                    w = w.contiguous(memory_format=_CL)
                elif w.dim() == 3:   # a 1x1 Conv1d, run as a linear layer
                    w = w[..., 0]
                mod.w = w
                mod.b = (None if mod.bias is None
                         else mod.bias.detach().to(dtype))
            elif isinstance(mod, nn.PReLU):
                mod.w = mod.weight.detach().to(dtype)
        for mod in self.modules():
            if isinstance(mod, _Attention):
                mod.qkv = torch.cat([mod.to_q.weight, mod.to_kv.weight]).to(
                    dtype)
                mod.emb = mod.rel_pos_emb.weight.detach().to(dtype)
            elif isinstance(mod, _FeedForward):
                second = mod.net[3]
                second.w = (0.5 * second.weight).to(dtype)
                second.b = (0.5 * second.bias).to(dtype)
            elif isinstance(mod, ConformerBlock):
                dw, bn = mod.conv.net[4].conv, mod.conv.net[5]
                s = bn.weight / torch.sqrt(bn.running_var + bn.eps)
                w = (dw.weight * s[:, None, None]).to(dtype)
                # (C, 1, k) -> (C, 1, 1, k): a conv over one row, whose
                # channels-last input is the (N, n, C) map as it lies
                mod.dw_w = w[:, :, None].contiguous(memory_format=_CL)
                mod.dw_b = ((dw.bias - bn.running_mean) * s + bn.bias).to(
                    dtype)
        return self

    def forward(self, x: torch.Tensor,
                frames: Optional[torch.Tensor] = None):
        """x (B, 2, T, F) float32, frames (B,) real frame counts or None
        (all T) -> (real, imag), each (B, 1, T, F) float32."""
        dt = self.dtype
        with span("idccrn.cmgan.enc"):
            mag = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2)[:, None]
            phase = torch.atan2(x[:, 1], x[:, 0])[:, None]
            h = torch.cat([mag, x], dim=1).to(dt).contiguous(memory_format=_CL)
            e = self.dense_encoder
            h = _cnp(h, e.conv_1, frames)
            h = _dense(h, e.dilated_dense, frames)
            h = _cnp(h, e.conv_2, frames, stride=(1, 2), padding=(0, 1))
        for i in range(self.num_tscb):
            with span("idccrn.cmgan.tscb"):
                h = self._tscb(getattr(self, f"TSCB_{i + 1}"), h, frames)
        with span("idccrn.cmgan.dec.mask"):
            md = self.mask_decoder
            m = _sub_pixel(_dense(h, md.dense_block, frames), md.sub_pixel)
            m = _conv(m, md.conv_1)
            m = F.prelu(_instance_norm(m, md.norm, frames), md.prelu.w)
            m = _conv(m, md.final_conv)[:, 0].float()       # (B, T, F)
            a = md.prelu_out.weight
            m = torch.where(m >= 0, m, a * m)[:, None]
            out_mag = m * mag
        with span("idccrn.cmgan.dec.complex"):
            cd = self.complex_decoder
            c = _sub_pixel(_dense(h, cd.dense_block, frames), cd.sub_pixel)
            c = F.prelu(_instance_norm(c, cd.norm, frames), cd.prelu.w)
            c = _conv(c, cd.conv).float()
            real = out_mag * torch.cos(phase) + c[:, 0:1]
            imag = out_mag * torch.sin(phase) + c[:, 1:2]
        return real, imag

    def _tscb(self, tscb, h, frames):
        """(B, C, T, F) channels-last -> the same."""
        b, c, t, f = h.shape
        xt = h.permute(0, 3, 2, 1).reshape(b * f, t, c)
        lens = None if frames is None else frames.repeat_interleave(f)
        xt = _conformer(tscb.time_conformer, xt, lens) + xt
        xf = xt.view(b, f, t, c).transpose(1, 2).reshape(b * t, f, c)
        xf = _conformer(tscb.freq_conformer, xf, None) + xf
        return xf.view(b, t, f, c).permute(0, 3, 1, 2)


# ------------------------------------------------------------ functions


def _conv(x, mod, stride=1, padding=0, dilation=1):
    return F.conv2d(x, mod.w, mod.b, stride, padding, dilation)


def _instance_norm(x, norm, frames):
    """InstanceNorm2d (affine) of (B, C, T, F) with float32 statistics
    over each row's first `frames` frames (all where None)."""
    xf = x.float()
    if frames is None:
        y = F.instance_norm(xf, weight=norm.weight, bias=norm.bias,
                            eps=norm.eps)
        return y.to(x.dtype)
    keep = (torch.arange(x.shape[2], device=x.device)[None, :]
            < frames[:, None]).float()[:, None, :, None]
    count = (frames.float() * x.shape[3])[:, None]
    xm = xf * keep
    mean = xm.sum((2, 3)) / count
    var = ((xm - mean[:, :, None, None] * keep) ** 2).sum((2, 3)) / count
    scale = norm.weight * torch.rsqrt(var + norm.eps)
    y = (xf - mean[:, :, None, None]) * scale[:, :, None, None] \
        + norm.bias[:, None, None]
    return y.to(x.dtype)


def _cnp(x, seq, frames, stride=(1, 1), padding=(0, 0)):
    """conv, InstanceNorm2d, PReLU of an nn.Sequential of the three."""
    conv, norm, prelu = seq
    return F.prelu(_instance_norm(_conv(x, conv, stride, padding), norm,
                                  frames), prelu.w)


def _dense(x, net, frames):
    """DilatedDenseNet: each layer sees every earlier output on the
    channel axis, time padded causally (dilation rows), frequency by 1."""
    skip = x
    for i in range(net.depth):
        dil = 2 ** i
        out = _conv(F.pad(skip, (1, 1, dil, 0)), getattr(net, f"conv{i + 1}"),
                    dilation=(dil, 1))
        out = F.prelu(_instance_norm(out, getattr(net, f"norm{i + 1}"),
                                     frames), getattr(net, f"prelu{i + 1}").w)
        if i + 1 < net.depth:
            skip = torch.cat([out, skip], dim=1)
    return out


def _sub_pixel(x, sp):
    """(B, C, T, F') -> (B, C, T, 2F'): a (1, 3) conv to rC channels, the
    r channel groups interleaved along frequency."""
    out = _conv(F.pad(x, (1, 1, 0, 0)), sp.conv)
    b, rc, t, f = out.shape
    out = out.view(b, sp.r, rc // sp.r, t, f).permute(0, 2, 3, 4, 1)
    return out.reshape(b, rc // sp.r, t, f * sp.r)


def _linear(x, mod):
    return F.linear(x, mod.w, mod.b)


def _ffn(ff, x):
    pre = ff.fn
    net = pre.fn.net
    h = F.layer_norm(x, x.shape[-1:], pre.norm.weight.to(x.dtype),
                     pre.norm.bias.to(x.dtype), pre.norm.eps)
    return _linear(F.silu(_linear(h, net[0])), net[3])


def _layer_norm(x, norm):
    return F.layer_norm(x, x.shape[-1:], norm.weight.to(x.dtype),
                        norm.bias.to(x.dtype), norm.eps)


def _conformer(blk, x, lens):
    """One ConformerBlock over (N, n, C); `lens` (N,) the rows' lengths
    (keys past a length masked out, the depthwise input zeroed there) or
    None."""
    n_rows, n, c = x.shape
    x = x + _ffn(blk.ff1, x)

    at = blk.attn.fn
    h = _layer_norm(x, blk.attn.norm)
    qkv = F.linear(h, at.qkv).view(n_rows, n, 3, at.heads, -1)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    with span("idccrn.cmgan.attn"):
        o = rel_attention(q, k, v, at.emb, lens)
    x = x + _linear(o.transpose(1, 2).reshape(n_rows, n, c), at.to_out)

    net = blk.conv.net
    h = _linear(_layer_norm(x, net[0]), net[2])
    h = F.glu(h, dim=-1)
    if lens is not None:
        h = h * (torch.arange(n, device=x.device)[None, :]
                 < lens[:, None])[:, :, None].to(h.dtype)
    # (N, n, 2C) as a channels-last (N, 2C, 1, n) map; BN folded in.
    # On the CPU in float32 from the same operands: torch's CPU bf16
    # depthwise conv stalls for minutes at some lengths
    w, b, dt = blk.dw_w, blk.dw_b, h.dtype
    if h.device.type == "cpu":
        h, w, b = h.float(), w.float(), b.float()
    h = F.conv2d(h[:, None].permute(0, 3, 1, 2), w, b,
                 padding=(0, blk.kernel // 2), groups=h.shape[-1])
    h = F.silu(h.to(dt)).permute(0, 2, 3, 1).reshape(n_rows, n, -1)
    x = x + _linear(h, net[7])

    x = x + _ffn(blk.ff2, x)
    return _layer_norm(x, blk.post_norm)
