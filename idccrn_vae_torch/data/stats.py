"""The reference's 257x2 text format of per-(freq-bin, re/im) corpus
statistics (dataset/cal_mean_std.py:51-103, read by train.py:505-511):
the port's copy of `save_stats_txt` / `load_stats_txt` from
`idccrn_vae_tpu/data/stats.py`. Computing the statistics
(`corpus_mean_std`, the cal_mean_std CLI) is not ported yet."""

from __future__ import annotations

import numpy as np


def save_stats_txt(path: str, arr: np.ndarray) -> None:
    np.savetxt(path, arr)


def load_stats_txt(mean_path: str, std_path: str):
    """Load the reference's 257x2 text files -> ((F,2), (F,2)) float32."""
    mean = np.loadtxt(mean_path).astype(np.float32)
    std = np.loadtxt(std_path).astype(np.float32)
    return mean, std
