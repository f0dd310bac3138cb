"""Spectral features of a waveform.

Mirrors `idccrn_vae_tpu/data/features.py`: the reference's feature types
(log power, magnitude, complex; dataset/featurelib_r.py) on this
package's STFT (`ops/stft.stft`), for tooling that wants framed features
instead of waveforms. Numpy in, numpy out; the STFT runs on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from idccrn_vae_torch.ops.stft import stft


def spec_features(
    x: np.ndarray,
    feattype: str = "LogPow",
    n_fft: int = 512,
    hop: int = 100,
    win_length: int = 400,
    min_gain_db: float = -80.0,
) -> np.ndarray:
    """Framed features of a waveform (L,).

    feattype: 'LogPow' (log power in dB, floored at min_gain_db under the
    peak), 'MagSpec' (linear magnitude) or 'Complex' (the spectrum,
    (F, T, 2)). Returns (F, T), or (F, T, 2) for 'Complex'.
    """
    wav = torch.from_numpy(np.asarray(x, np.float32))[None]
    spec = stft(wav, n_fft, hop, win_length)[0].numpy()  # (F, T, 2)
    if feattype == "Complex":
        return spec
    power = spec[..., 0] ** 2 + spec[..., 1] ** 2
    if feattype == "MagSpec":
        return np.sqrt(power)
    if feattype == "LogPow":
        p_min = power.max() * 10.0 ** (min_gain_db / 10.0)
        return 10.0 * np.log10(np.maximum(power, max(p_min, 1e-12)))
    raise ValueError(f"unknown feattype {feattype}")
