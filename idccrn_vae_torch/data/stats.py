"""Offline corpus spectrogram statistics (the cal_mean_std CLI).

The port of `idccrn_vae_tpu/data/stats.py`: per-(freq-bin, re/im) mean
and std over a corpus's STFT frames, in the reference's 257x2 text
format (dataset/cal_mean_std.py:51-103, read by train.py:505-511).

Framing and windowing run on the host (cheap, variable length); frames
fill a fixed-size buffer, and each full buffer is flushed to the device
(the card by default) for one rfft and the per-bin sums. The host adds
the flushes up in float64.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from idccrn_vae_torch.data.audio_io import read_wav, trim_silence
from idccrn_vae_torch.device import DeviceLike, resolve_device
from idccrn_vae_torch.ops.stft import _padded_hann

_CHUNK = 4096  # frames per device flush


def _frames_of(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    return x[idx]


def corpus_mean_std(file_list: Sequence[str], n_fft: int = 512,
                    hop: int = 100, win_length: int = 400, trim: bool = True,
                    fs: int = 16000, device: DeviceLike = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (mean, std), each (F, 2) float32. Runs the rfft and the
    sums on the CUDA card unless `device` names another device; raises
    if no file yields a frame."""
    device = resolve_device(device)
    f_bins = n_fft // 2 + 1
    window = _padded_hann(win_length, n_fft, device, torch.float32)
    s1 = np.zeros((f_bins, 2), np.float64)
    s2 = np.zeros((f_bins, 2), np.float64)
    count = 0
    buf = np.zeros((_CHUNK, n_fft), np.float32)
    fill = 0

    def drain(n):
        nonlocal count
        frames = torch.from_numpy(buf[:n]).to(device)
        spec = torch.view_as_real(torch.fft.rfft(frames * window, n=n_fft,
                                                 dim=-1))  # (N, F, 2)
        sums = torch.stack([spec.sum(dim=0), (spec * spec).sum(dim=0)])
        a, b = sums.cpu().numpy().astype(np.float64)
        s1[...] += a
        s2[...] += b
        count += n

    for path in file_list:
        x, fs_x = read_wav(path)
        if x.ndim > 1:
            x = x[:, 0]
        if fs_x != fs:
            raise ValueError(f"unexpected fs {fs_x} for {path}")
        if trim:
            b, e = trim_silence(x, 30.0)
            x = x[b:e]
        if len(x) < n_fft:
            continue
        frames = _frames_of(x.astype(np.float32), n_fft, hop)
        i = 0
        while i < len(frames):
            take = min(_CHUNK - fill, len(frames) - i)
            buf[fill : fill + take] = frames[i : i + take]
            fill += take
            i += take
            if fill == _CHUNK:
                drain(_CHUNK)
                fill = 0
    if fill:
        drain(fill)

    if count == 0:
        # all-zero statistics would be written to disk and blow training
        # up later through datanorm's 1 / (std + 1e-6): fail here
        raise ValueError(
            "corpus_mean_std accumulated 0 frames "
            f"({len(list(file_list))} files, n_fft={n_fft}, trim={trim})")
    mean = s1 / count
    var = s2 / count - mean ** 2
    std = np.sqrt(np.maximum(var, 0.0))
    return mean.astype(np.float32), std.astype(np.float32)


def save_stats_txt(path: str, arr: np.ndarray) -> None:
    np.savetxt(path, arr)


def load_stats_txt(mean_path: str, std_path: str):
    """Load the reference's 257x2 text files -> ((F,2), (F,2)) float32."""
    mean = np.loadtxt(mean_path).astype(np.float32)
    std = np.loadtxt(std_path).astype(np.float32)
    return mean, std
