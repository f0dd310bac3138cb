"""The plain reference of I-DCCRN-VAE: float32 PyTorch, written from the
model's equations (Xiang et al.'s DCCRN-VAE family, iris1997jiatong/
I-DCCRN-VAE), and nothing of the program under test.

Layout: the original model's, a complex map is a pair (re, im) of
(B, C, F, T) real tensors. The block order, the epsilons and the
weights' names and layouts are those of the original PyTorch model
(`encoders.{i}.conv.conv_re.weight`, ...), so one state dict serves
both sides.

  stft        torch.stft, centred, reflect padding, periodic Hann of
              win_length zero-padded to n_fft
  conv        complex conv as four real convs, each conv's own bias in
              each pass; causal: time padded (1, 1), last column dropped
  tconv       complex transposed conv, the same four passes; causal:
              last time column dropped
  BN          complex (2x2 whitening) batch norm, eval (running
              statistics) or train (batch statistics over B, F, T)
  PReLU       one shared slope on real and imaginary parts
  LSTM        torch's gate order (i, f, g, o), a step loop per real
              LSTM; the complex LSTM is re = L_re(x_re) - L_im(x_im),
              im = L_re(x_im) + L_im(x_re)
  head        the LSTM's 3*zdim (two latents: 6*zdim) outputs sliced
              into (mu, log sigma, delta); the reparameterisation with
              the |delta| <= 0.99 sigma projection
  decoder     complex dense (separate real and imaginary linears), the
              C-major bottleneck unflatten, transposed convs with the
              encoder's skips concatenated on the channel axis

`Precision` rounds the operands of every convolution and matrix product
to a lower type and keeps float32 elsewhere; `F32` is the reference,
`BF16` the control of an f32 configuration.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

Pair = Tuple[torch.Tensor, torch.Tensor]
BN_EPS = 1e-5
LATENT_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Precision:
    """Operand type of the convolutions and matrix products."""

    operand: Optional[torch.dtype] = None

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.operand is None else t.to(self.operand).float()


F32 = Precision()
BF16 = Precision(torch.bfloat16)


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


# ---------------------------------------------------------------- geometry


@dataclasses.dataclass(frozen=True)
class Geometry:
    """The shapes a configuration file's "model" and "stft" blocks fix."""

    channels: Tuple[int, ...]
    kernel: Tuple[int, int]
    stride: Tuple[int, int]
    freq_pad: int
    zdim: int
    lstm_layers: int
    skip_to_use: Tuple[int, ...]
    n_fft: int
    hop: int
    win_length: int

    @staticmethod
    def of(config: dict) -> "Geometry":
        m, s = config["model"], config["stft"]
        if not m["causal"]:
            raise ValueError("the reference covers the causal model")
        return Geometry(tuple(m["encoder_channels"]), tuple(m["kernel"]),
                        tuple(m["stride"]), m["freq_pad"], m["zdim"],
                        m["lstm_layers"], tuple(m["skip_to_use"]),
                        s["n_fft"], s["hop"], s["win_length"])

    @property
    def stages(self) -> int:
        return len(self.channels) - 1

    def freqs(self) -> List[int]:
        """Frequency bins at the input and after each encoder stage."""
        f = [self.n_fft // 2 + 1]
        for _ in range(self.stages):
            f.append((f[-1] + 2 * self.freq_pad - self.kernel[0])
                     // self.stride[0] + 1)
        return f

    def encoder_plan(self, double: bool) -> List[Tuple[int, int]]:
        ch = list(self.channels)
        if double:
            ch = [ch[0]] + [2 * c for c in ch[1:]]
        return [(ch[i], ch[i + 1]) for i in range(self.stages)]

    def decoder_plan(self) -> List[Tuple[int, int, int]]:
        """(x channels, skip channels, out channels) per decoder stage."""
        de = tuple(reversed(self.channels[1:])) + (1,)
        n = self.stages
        return [(de[i], self.channels[n - i] if i in self.skip_to_use else 0,
                 de[i + 1]) for i in range(n)]

    def bottleneck(self, double: bool) -> Tuple[int, int]:
        return self.encoder_plan(double)[-1][1], self.freqs()[-1]


# ----------------------------------------------------------------- weights


def _bn_leaves(prefix: str, c: int) -> List[tuple]:
    return [(f"{prefix}.gamma_rr", (c,), ("const", 1.0)),
            (f"{prefix}.gamma_ri", (c,), ("normal",)),
            (f"{prefix}.gamma_ii", (c,), ("const", 1.0)),
            (f"{prefix}.beta_r", (c,), ("const", 0.0)),
            (f"{prefix}.beta_i", (c,), ("const", 0.0)),
            (f"{prefix}.running_mean_real", (1, c, 1, 1), ("const", 0.0)),
            (f"{prefix}.running_mean_imag", (1, c, 1, 1), ("const", 0.0)),
            (f"{prefix}.Vrr", (1, c, 1, 1), ("const", 1.0)),
            (f"{prefix}.Vri", (1, c, 1, 1), ("const", 0.0)),
            (f"{prefix}.Vii", (1, c, 1, 1), ("const", 1.0))]


def encoder_layout(geo: Geometry, latents: int = 1,
                   double: bool = False) -> List[tuple]:
    """(name, shape, init) of an encoder: the CVAE encoder, or the NSVAE
    encoder of one or two latents (two: every channel count but the
    input's doubled)."""
    kh, kw = geo.kernel
    out = []
    for i, (cin, cout) in enumerate(geo.encoder_plan(double)):
        for part in ("conv_re", "conv_im"):
            fan = ("uniform", cin * kh * kw)
            out += [(f"encoders.{i}.conv.{part}.weight", (cout, cin, kh, kw),
                     fan), (f"encoders.{i}.conv.{part}.bias", (cout,), fan)]
        out += _bn_leaves(f"encoders.{i}.bn", cout)
        out.append((f"encoders.{i}.prelu.weight", (1,), ("const", 0.25)))
    c, f = geo.bottleneck(double)
    hid = 3 * geo.zdim * latents
    for part in ("lstm_re", "lstm_im"):
        for k in range(geo.lstm_layers):
            cin = c * f if k == 0 else hid
            fan = ("uniform", hid)
            out += [(f"lstms.0.{part}.weight_ih_l{k}", (4 * hid, cin), fan),
                    (f"lstms.0.{part}.weight_hh_l{k}", (4 * hid, hid), fan),
                    (f"lstms.0.{part}.bias_ih_l{k}", (4 * hid,), fan),
                    (f"lstms.0.{part}.bias_hh_l{k}", (4 * hid,), fan)]
    return out


def decoder_layout(geo: Geometry) -> List[tuple]:
    kh, kw = geo.kernel
    c, f = geo.bottleneck(False)
    out = []
    for part in ("linear_read", "linear_imag"):
        fan = ("uniform", geo.zdim)
        out += [(f"dense.{part}.weight", (c * f, geo.zdim), fan),
                (f"dense.{part}.bias", (c * f,), fan)]
    for i, (cx, cs, cout) in enumerate(geo.decoder_plan()):
        for part in ("tconv_re", "tconv_im"):
            fan = ("uniform", cout * kh * kw)
            out += [(f"decoders.{i}.transconv.{part}.weight",
                     (cx + cs, cout, kh, kw), fan),
                    (f"decoders.{i}.transconv.{part}.bias", (cout,), fan)]
        out += _bn_leaves(f"decoders.{i}.bn", cout)
        out.append((f"decoders.{i}.prelu.weight", (1,), ("const", 0.25)))
    return out


# ---------------------------------------------------------------- the ops


def hann(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, device=device)


def stft(wav: torch.Tensor, geo: Geometry) -> Pair:
    """(B, L) -> (re, im), each (B, 1, F, T)."""
    spec = torch.stft(wav, geo.n_fft, geo.hop, geo.win_length,
                      window=hann(geo.win_length, wav.device), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.real[:, None], spec.imag[:, None]


def istft(re: torch.Tensor, im: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """(B, F, T) spectra -> (B, (T - 1) * hop)."""
    t = re.shape[-1]
    return torch.istft(torch.complex(re, im), geo.n_fft, geo.hop,
                       geo.win_length, window=hann(geo.win_length, re.device),
                       center=True, length=(t - 1) * geo.hop)


def complex_conv(x: Pair, w: Dict[str, torch.Tensor], prefix: str,
                 geo: Geometry, p: Precision) -> Pair:
    """Causal complex conv: time padded (1, 1), the last column dropped."""
    wr, wi = p(w[f"{prefix}.conv_re.weight"]), p(w[f"{prefix}.conv_im.weight"])
    br, bi = w[f"{prefix}.conv_re.bias"], w[f"{prefix}.conv_im.bias"]
    pad = (1, 1, geo.freq_pad, geo.freq_pad)
    xr, xi = (p(F.pad(t, pad)) for t in x)
    conv = lambda t, k, b: F.conv2d(t, k, b, stride=geo.stride)[..., :-1]
    re = conv(xr, wr, br) - conv(xi, wi, bi)
    im = conv(xi, wr, br) + conv(xr, wi, bi)
    return re, im


def complex_tconv(x: Pair, w: Dict[str, torch.Tensor], prefix: str,
                  geo: Geometry, p: Precision) -> Pair:
    """Causal complex transposed conv: the last time column dropped."""
    wr = p(w[f"{prefix}.tconv_re.weight"])
    wi = p(w[f"{prefix}.tconv_im.weight"])
    br, bi = w[f"{prefix}.tconv_re.bias"], w[f"{prefix}.tconv_im.bias"]
    xr, xi = (p(t) for t in x)
    conv = lambda t, k, b: F.conv_transpose2d(
        t, k, b, stride=geo.stride, padding=(geo.freq_pad, 0))[..., :-1]
    re = conv(xr, wr, br) - conv(xi, wi, bi)
    im = conv(xi, wr, br) + conv(xr, wi, bi)
    return re, im


def _whitening(vrr, vii, vri):
    det = torch.clamp(vrr * vii - vri * vri + BN_EPS, min=1e-8)
    s = torch.sqrt(det)
    t = torch.sqrt(vrr + vii + 2.0 * s + BN_EPS)
    inv = 1.0 / (s * t + BN_EPS)
    return (vii + s) * inv, (vrr + s) * inv, -vri * inv


def complex_bn(x: Pair, w: Dict[str, torch.Tensor], prefix: str,
               train: bool) -> Pair:
    """Complex BN; train: the batch's mean and covariance over (B, F, T)."""
    xr, xi = x
    col = lambda k: w[f"{prefix}.{k}"].reshape(1, -1, 1, 1)
    if train:
        mr = xr.mean(dim=(0, 2, 3), keepdim=True)
        mi = xi.mean(dim=(0, 2, 3), keepdim=True)
        cr, ci = xr - mr, xi - mi
        vrr = (cr * cr).mean(dim=(0, 2, 3), keepdim=True) + BN_EPS
        vii = (ci * ci).mean(dim=(0, 2, 3), keepdim=True) + BN_EPS
        vri = (cr * ci).mean(dim=(0, 2, 3), keepdim=True)
    else:
        cr = xr - col("running_mean_real")
        ci = xi - col("running_mean_imag")
        vrr, vii, vri = col("Vrr"), col("Vii"), col("Vri")
    wrr, wii, wri = _whitening(vrr, vii, vri)
    nr = wrr * cr + wri * ci
    ni = wri * cr + wii * ci
    grr, gri, gii = col("gamma_rr"), col("gamma_ri"), col("gamma_ii")
    return (grr * nr + gri * ni + col("beta_r"),
            gri * nr + gii * ni + col("beta_i"))


def prelu(x: Pair, alpha: torch.Tensor) -> Pair:
    return F.prelu(x[0], alpha), F.prelu(x[1], alpha)


def lstm(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
         layers: int, p: Precision,
         state: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None):
    """Multi-layer LSTM (B, T, In) -> ((B, T, H), final (h, c) per layer)."""
    finals = []
    for k in range(layers):
        w_ih = p(w[f"{prefix}.weight_ih_l{k}"])
        w_hh = p(w[f"{prefix}.weight_hh_l{k}"])
        bias = w[f"{prefix}.bias_ih_l{k}"] + w[f"{prefix}.bias_hh_l{k}"]
        xw = p(x) @ w_ih.t() + bias
        hid = w_hh.shape[1]
        if state is None:
            h = x.new_zeros(x.shape[0], hid)
            c = x.new_zeros(x.shape[0], hid)
        else:
            h, c = state[k]
        outs = []
        for t in range(x.shape[1]):
            gates = xw[:, t] + p(h) @ w_hh.t()
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        x = torch.stack(outs, dim=1)
        finals.append((h, c))
    return x, finals


def complex_lstm(xr: torch.Tensor, xi: torch.Tensor, w, geo: Geometry,
                 p: Precision, state=None):
    """(B, T, In) pair -> (re, im) (B, T, H) and the final states: per
    layer of each real LSTM (re, im), the batch [x_re; x_im]."""
    b = xr.shape[0]
    both = torch.cat([xr, xi])
    s_re = None if state is None else state["re"]
    s_im = None if state is None else state["im"]
    o_re, f_re = lstm(both, w, "lstms.0.lstm_re", geo.lstm_layers, p, s_re)
    o_im, f_im = lstm(both, w, "lstms.0.lstm_im", geo.lstm_layers, p, s_im)
    re = o_re[:b] - o_im[b:]
    im = o_re[b:] + o_im[:b]
    return re, im, {"re": f_re, "im": f_im}


# ------------------------------------------------------------------ model


@dataclasses.dataclass
class Posterior:
    mu_r: torch.Tensor
    mu_i: torch.Tensor
    log_sigma: torch.Tensor
    delta_r: torch.Tensor
    delta_i: torch.Tensor


def flatten(x: Pair) -> Pair:
    """(B, C, F, T) -> (B, T, C*F), index c*F + f."""
    return tuple(t.reshape(t.shape[0], -1, t.shape[-1]).transpose(1, 2)
                 for t in x)


def unflatten(t: torch.Tensor, c: int, f: int) -> torch.Tensor:
    """(B, T, C*F) -> (B, C, F, T)."""
    return t.transpose(1, 2).reshape(t.shape[0], c, f, t.shape[1])


def encode(x: Pair, w, geo: Geometry, p: Precision, train: bool = False):
    """Conv stack: spectrum pair (B, 1, F, T) -> (bottleneck, skips)."""
    skips = []
    for i in range(geo.stages):
        x = complex_conv(x, w, f"encoders.{i}.conv", geo, p)
        x = complex_bn(x, w, f"encoders.{i}.bn", train)
        x = prelu(x, w[f"encoders.{i}.prelu.weight"])
        skips.append(x)
    return x, skips


def heads(re: torch.Tensor, im: torch.Tensor, zdim: int,
          latents: int) -> List[Posterior]:
    z = zdim
    return [Posterior(re[..., o: o + z], im[..., o: o + z],
                      re[..., o + z: o + 2 * z], re[..., o + 2 * z: o + 3 * z],
                      im[..., o + 2 * z: o + 3 * z])
            for o in (3 * z * k for k in range(latents))]


def project_delta(sigma, dr, di, eps: float, factor: float):
    """|delta| <= factor * sigma where it reaches sigma - 1e-3."""
    mag = torch.sqrt(dr * dr + di * di + eps)
    scale = sigma * factor / (mag + eps)
    over = mag >= sigma - 1e-3
    return torch.where(over, dr * scale, dr), torch.where(over, di * scale, di)


def sample(g: Posterior, eps_r: torch.Tensor, eps_i: torch.Tensor) -> Pair:
    """z = mu + L eps with L the complex Gaussian's real 2x2 factor.
    eps_* (B, S, T, H) -> z_r, z_i, each (B*S, T, H), sample-minor."""
    sigma = torch.exp(g.log_sigma)
    dr, di = project_delta(sigma, g.delta_r, g.delta_i, LATENT_EPS, 0.99)
    d2 = dr * dr + di * di + LATENT_EPS
    denom = torch.sqrt(2.0 * (sigma + dr) + LATENT_EPS) + LATENT_EPS
    a = ((sigma + dr) / denom)[:, None]
    b = (di / denom)[:, None]
    c = (torch.sqrt(sigma * sigma - d2 + LATENT_EPS) / denom)[:, None]
    zr = g.mu_r[:, None] + a * eps_r
    zi = g.mu_i[:, None] + b * eps_r + c * eps_i
    return tuple(t.reshape((-1,) + tuple(t.shape[2:])) for t in (zr, zi))


def decode(z: Pair, skips: Optional[List[Pair]], w, geo: Geometry,
           p: Precision, train: bool = False) -> Pair:
    """(z_r, z_i) (N, T, zdim) -> the decoder's spectrum pair (N, F, T).

    skips: per encoder stage, each repeated to N rows already; None
    concatenates zeros in their place (the CVAE trained with skip
    padding)."""
    c, f = geo.bottleneck(False)
    x = (unflatten(p(z[0]) @ p(w["dense.linear_read.weight"]).t()
                   + w["dense.linear_read.bias"], c, f),
         unflatten(p(z[1]) @ p(w["dense.linear_imag.weight"]).t()
                   + w["dense.linear_imag.bias"], c, f))
    n = geo.stages
    for i, (_, cs, _) in enumerate(geo.decoder_plan()):
        if cs:
            s = ((torch.zeros_like(x[0][:, :cs]),) * 2 if skips is None
                 else skips[n - 1 - i])
            x = (torch.cat([x[0], s[0]], 1), torch.cat([x[1], s[1]], 1))
        x = complex_tconv(x, w, f"decoders.{i}.transconv", geo, p)
        x = complex_bn(x, w, f"decoders.{i}.bn", train)
        x = prelu(x, w[f"decoders.{i}.prelu.weight"])
    return x[0][:, 0], x[1][:, 0]


def split_skip(s: Pair, which: int) -> Pair:
    """A two-latent encoder's skip: its first half of channels is the
    speech decoder's, the second the noise decoder's."""
    c = s[0].shape[1] // 2
    sl = slice(0, c) if which == 0 else slice(c, 2 * c)
    return s[0][:, sl], s[1][:, sl]


def enhance(wav: torch.Tensor, weights: Sequence[dict], geo: Geometry,
            num_samples: int, outtype: str, draws: Sequence[Pair],
            p: Precision = F32) -> torch.Tensor:
    """The enhancement program: (B, L) -> (B, (T - 1) * hop).

    weights: (encoder, speech decoder[, noise decoder]); draws: (eps_r,
    eps_i) per latent, each (B, S, T, zdim). 'clean_direct' averages the
    speech decoder's waveforms over the S samples; the masks average
    both decoders' spectra S and N over the samples and scale the noisy
    spectrum Y: 'real_imag_mask' each part by S^2 / (S^2 + N^2 +
    1e-10), 'complex_mask' by S / (S + N + 1e-10). The decoders run one
    sample at a time."""
    enc = weights[0]
    latents = 1 if outtype == "clean_direct" else 2
    y = stft(wav, geo)
    bott, skips = encode(y, enc, geo, p)
    re, im, _ = complex_lstm(*flatten(bott), enc, geo, p)
    posts = heads(re, im, geo.zdim, latents)
    s = num_samples
    if outtype == "clean_direct":
        acc = 0.0
        for k in range(s):
            z = sample(posts[0], draws[0][0][:, k:k + 1],
                       draws[0][1][:, k:k + 1])
            spec = decode(z, skips, weights[1], geo, p)
            acc = acc + istft(*spec, geo)
        return acc / s
    if outtype not in ("real_imag_mask", "complex_mask"):
        raise ValueError(f"the reference covers clean_direct, "
                         f"real_imag_mask and complex_mask, not {outtype}")
    means = []
    for which in (0, 1):
        sk = [split_skip(t, which) for t in skips]
        acc_r = acc_i = 0.0
        for k in range(s):
            z = sample(posts[which], draws[which][0][:, k:k + 1],
                       draws[which][1][:, k:k + 1])
            sr, si = decode(z, sk, weights[1 + which], geo, p)
            acc_r, acc_i = acc_r + sr, acc_i + si
        means.append((acc_r / s, acc_i / s))
    (sr, si), (nr, ni) = means
    yr, yi = y[0][:, 0], y[1][:, 0]
    if outtype == "real_imag_mask":
        return istft(sr * sr / (sr * sr + nr * nr + 1e-10) * yr,
                     si * si / (si * si + ni * ni + 1e-10) * yi, geo)
    sp, nz = torch.complex(sr, si), torch.complex(nr, ni)
    est = sp / (sp + nz + 1e-10) * torch.complex(yr, yi)
    return istft(est.real, est.imag, geo)


def stream_enhance(wav: torch.Tensor, weights: Sequence[dict],
                   geo: Geometry, p: Precision = F32) -> torch.Tensor:
    """Causal enhancement of a whole stream (B, L), L a multiple of hop,
    with the latent's mean and the framing of a stream: the signal led
    by n_fft - hop zeros (no reflection), one frame per hop, the output
    overlap-added and divided by the windows' squared sum (clamped at
    1e-8). Returns (B, L): sample q of the output belongs to input
    sample q - (n_fft - hop)."""
    enc, dec = weights
    b, length = wav.shape
    lead = geo.n_fft - geo.hop
    win = F.pad(hann(geo.win_length, wav.device),
                ((geo.n_fft - geo.win_length) // 2,) * 2)
    frames = F.pad(wav, (lead, 0)).unfold(-1, geo.n_fft, geo.hop) * win
    spec = torch.fft.rfft(frames, dim=-1).transpose(1, 2)  # (B, F, T)
    y = (spec.real[:, None].contiguous(), spec.imag[:, None].contiguous())
    bott, skips = encode(y, enc, geo, p)
    re, im, _ = complex_lstm(*flatten(bott), enc, geo, p)
    g = heads(re, im, geo.zdim, 1)[0]
    sr, si = decode((g.mu_r, g.mu_i), skips, dec, geo, p)
    out = torch.fft.irfft(torch.complex(sr, si).transpose(1, 2),
                          n=geo.n_fft, dim=-1) * win
    t = out.shape[1]
    cover = (t - 1) * geo.hop + geo.n_fft
    ola = F.fold(out.transpose(1, 2), (1, cover), (1, geo.n_fft),
                 stride=(1, geo.hop)).reshape(b, cover)
    env = F.fold((win * win).expand(1, t, -1).transpose(1, 2), (1, cover),
                 (1, geo.n_fft), stride=(1, geo.hop)).reshape(cover)
    return ola[:, :length] / env[:length].clamp_min(1e-8)
