"""STFT / ISTFT with torch.stft/istft semantics, on cuFFT.

Mirrors `idccrn_vae_tpu/ops/stft.py`:

  * center=True reflect padding of n_fft//2 samples on both sides,
  * the periodic win_length window zero-padded centred to n_fft: Hann by
    default, or Hamming (`window="hamming"`, CMGAN's),
  * frame count ``1 + L // hop``,
  * ISTFT overlap-add divided by the squared-window envelope, clamped at
    1e-11 so that a `length` past the frames' coverage gives zeros where
    torch.istft would raise (the envelope is 0 there).

Spectra are (B, F, T, 2) real/imag, the JAX package's layout.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def _traced() -> bool:
    """Inside torch.export or torch.compile tracing: a tensor built there
    is a constant of the traced graph (a fake tensor while tracing), so
    it must not enter the eager caches below."""
    return torch.compiler.is_exporting() or torch.compiler.is_compiling()


WINDOWS = ("hann", "hamming")


def hann_window(win_length: int, n_fft: int, device: torch.device,
                dtype: torch.dtype, window: str = "hann") -> torch.Tensor:
    """`_padded_hann` (or the `window` it names), from its cache except
    while tracing."""
    build = _padded_hann.__wrapped__ if _traced() else _padded_hann
    return build(win_length, n_fft, device, dtype, window)


def ola_envelope(frames: int, n_fft: int, hop: int, win_length: int,
                 device: torch.device, dtype: torch.dtype,
                 window: str = "hann") -> torch.Tensor:
    """`_ola_envelope`, from its cache except while tracing."""
    build = _ola_envelope.__wrapped__ if _traced() else _ola_envelope
    return build(frames, n_fft, hop, win_length, device, dtype, window)


@functools.lru_cache(maxsize=16)
def _padded_hann(win_length: int, n_fft: int, device: torch.device,
                 dtype: torch.dtype, window: str = "hann") -> torch.Tensor:
    """Periodic Hann of win_length (`window="hamming"`: periodic Hamming,
    0.54 - 0.46 cos, as torch.hamming_window), zero-padded centred to
    n_fft.

    Built in float64 on the host and cast once; cached per device and
    dtype. The cached tensor is shared, so callers never write to it. It
    is built outside inference mode whatever the first caller's mode, so
    a training step can save it for backward after a serving call has
    cached it.
    """
    if window not in WINDOWS:
        raise ValueError(f"unknown window {window!r}; one of {WINDOWS}")
    n = np.arange(win_length)
    if window == "hann":
        w = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / win_length))
    else:
        w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=np.float64)
    out[left : left + win_length] = w
    with torch.inference_mode(False):
        return torch.as_tensor(out, dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def _ola_envelope(frames: int, n_fft: int, hop: int, win_length: int,
                  device: torch.device, dtype: torch.dtype,
                  window: str = "hann") -> torch.Tensor:
    """Overlap-added squared window over `frames` frames, (cover,), built
    outside inference mode like `_padded_hann`."""
    window = hann_window(win_length, n_fft, device, dtype, window)
    with torch.inference_mode(False), torch.no_grad():
        return _overlap_add((window * window).expand(1, frames, n_fft),
                            hop)[0]


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, T, n) frames -> (B, (T - 1) * hop + n) summed signal."""
    b, t, n = frames.shape
    cover = (t - 1) * hop + n
    out = F.fold(frames.transpose(1, 2), output_size=(1, cover),
                 kernel_size=(1, n), stride=(1, hop))
    return out.view(b, cover)


def stft(signal: torch.Tensor, n_fft: int = 512, hop: int = 100,
         win_length: int = 400, window: str = "hann") -> torch.Tensor:
    """(B, L) or (L,) waveform -> (B, F, T, 2) spectrum, F = n_fft//2 + 1."""
    squeeze = signal.dim() == 1
    if squeeze:
        signal = signal[None]
    pad = n_fft // 2
    x = F.pad(signal[:, None], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)  # (B, T, n_fft), a view
    w = hann_window(win_length, n_fft, signal.device, signal.dtype, window)
    spec = torch.fft.rfft(frames * w, n=n_fft, dim=-1)  # (B, T, F)
    out = torch.view_as_real(spec).transpose(1, 2).contiguous()
    out = out.to(signal.dtype)
    return out[0] if squeeze else out


def istft(spec: torch.Tensor, n_fft: int = 512, hop: int = 100,
          win_length: int = 400, length: Optional[int] = None,
          window: str = "hann",
          frames: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, F, T, 2) or (F, T, 2) spectrum -> (B, length) waveform.

    length defaults to (T - 1) * hop like torch.istft. `frames` (B,):
    each row's count of real frames; the frames past it are left out of
    the sum and of the envelope, so a row's samples are torch.istft's of
    its real frames alone, up to where those frames reach.
    """
    squeeze = spec.dim() == 3
    if squeeze:
        spec = spec[None]
    dtype = spec.dtype
    b, _, t, _ = spec.shape
    w = hann_window(win_length, n_fft, spec.device, dtype, window)
    cplx = torch.view_as_complex(spec.contiguous()).transpose(1, 2)
    parts = torch.fft.irfft(cplx, n=n_fft, dim=-1).to(dtype) * w

    pad = n_fft // 2
    if length is None:
        length = (t - 1) * hop
    full = length + 2 * pad
    if frames is None:
        env = ola_envelope(t, n_fft, hop, win_length, spec.device, dtype,
                           window)
    else:
        keep = (torch.arange(t, device=spec.device)[None, :]
                < frames[:, None]).to(dtype)[:, :, None]
        parts = parts * keep
        env = _overlap_add(w * w * keep, hop)
    sig = _overlap_add(parts, hop)
    cover = sig.shape[-1]
    if full > cover:
        # past the last frame's span both are 0: the clamp below turns
        # 0/0 into 0, as the JAX package does
        sig = F.pad(sig, (0, full - cover))
        env = F.pad(env, (0, full - cover))
    sig = sig[:, pad : pad + length]
    env = env[..., pad : pad + length]
    out = sig / env.clamp_min(1e-11)
    return out[0] if squeeze else out
