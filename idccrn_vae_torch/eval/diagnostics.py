"""Latent-space diagnostics (the reference's eval-side analyses).

  * mu covariance diagnostics + plot of cov(mu) diagonals
    (test_prevae.py:299-344),
  * silhouette score between speech/noise latent sets and per-dim
    variance analysis (test_nsvae_se.py:39-76, 482-502).

The port's copy of `idccrn_vae_tpu/eval/diagnostics.py`. matplotlib and
scikit-learn are imported lazily, as there: `latent_silhouette` returns
None without scikit-learn, and `plot_cov_diagonals` raises ImportError
without matplotlib. One deviation from the JAX package, in the caller:
a CUDA machine often has neither plotting nor scikit-learn installed,
and a figure is the one output of an evaluation that no score depends
on, so the port's `run_vae_reconstruction_eval` writes every number,
skips only the figure and logs one line saying so, where the JAX runner
raises.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def mu_covariance(mus: Sequence[np.ndarray]) -> dict:
    """Stack per-utterance mean latents (T_i, H, 2) and compute per-dim
    variance + covariance diagonals for real and imag parts."""
    flat = np.concatenate([np.asarray(m).reshape(-1, m.shape[-2], 2)
                           for m in mus], axis=0)  # (N, H, 2)
    out = {}
    for name, idx in (("real", 0), ("imag", 1)):
        x = flat[..., idx]  # (N, H)
        cov = np.cov(x, rowvar=False)
        out[f"var_{name}"] = np.diag(cov)
        out[f"cov_{name}"] = cov
        out[f"offdiag_mean_abs_{name}"] = float(
            np.mean(np.abs(cov - np.diag(np.diag(cov)))))
    return out


def plot_cov_diagonals(diag: dict, path: str) -> None:
    """Save the cov(mu) diagonal plot (test_prevae.py matplotlib dump)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(diag["var_real"], label="cov(mu) diag — real")
    ax.plot(diag["var_imag"], label="cov(mu) diag — imag")
    ax.set_xlabel("latent dim")
    ax.set_ylabel("variance")
    ax.legend()
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def posterior_distance(v1: np.ndarray, v2: np.ndarray,
                       is_logsigma: bool = False) -> float:
    """RMS distance between two posterior parameter fields — the
    reference's per-utterance mu/sigma/delta diagnostics
    (test_nsvae_se.py:27-35, 416-418). v1/v2: (..., H, 2); log-sigma
    inputs are exponentiated (real part) first."""
    v1 = np.asarray(v1, np.float64)
    v2 = np.asarray(v2, np.float64)
    if is_logsigma:
        v1 = np.exp(v1[..., :1])
        v2 = np.exp(v2[..., :1])
    axes = tuple(range(v1.ndim - 2))
    res = np.mean((v1 - v2) ** 2, axis=axes)  # (H, 2) or (H, 1)
    return float(np.sqrt(np.sum(res)))


def latent_silhouette(speech_mus: Sequence[np.ndarray],
                      noise_mus: Sequence[np.ndarray],
                      max_points: int = 20000,
                      seed: int = 0) -> Optional[float]:
    """Silhouette score of speech-vs-noise latent means
    (test_nsvae_se.py:39-76). Returns None if sklearn is unavailable."""
    try:
        from sklearn.metrics import silhouette_score
    except ImportError:  # pragma: no cover
        return None
    s = np.concatenate([np.asarray(m).reshape(-1, m.shape[-2] * 2)
                        for m in speech_mus], axis=0)
    n = np.concatenate([np.asarray(m).reshape(-1, m.shape[-2] * 2)
                        for m in noise_mus], axis=0)
    x = np.concatenate([s, n], axis=0)
    labels = np.concatenate([np.zeros(len(s)), np.ones(len(n))])
    if len(x) > max_points:
        sel = np.random.default_rng(seed).choice(len(x), max_points,
                                                 replace=False)
        x, labels = x[sel], labels[sel]
    return float(silhouette_score(x, labels))
