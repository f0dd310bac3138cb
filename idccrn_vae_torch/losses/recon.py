"""Reconstruction losses: SI-SNR, complex + magnitude MSE, prob recon.

Mirrors `idccrn_vae_tpu/losses/recon.py` (sisnr_loss.py:7-24 and
pretrain_pvaes_loss.py:161-206 of the reference).
"""

from __future__ import annotations

from typing import Sequence

import torch


def si_snr_loss(source: torch.Tensor, estimate: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """Negative mean SI-SNR in dB. source/estimate: (B, L).

    s_target = (<est, src> / ||src||^2) * src, the reference's
    diag(matmul) projection written out.
    """
    dot = (source * estimate).sum(dim=-1, keepdim=True)
    energy = (source * source).sum(dim=-1, keepdim=True)
    s_target = dot * source / (energy + eps)
    e_noise = estimate - s_target
    snr = 10.0 * torch.log10(
        (s_target ** 2).sum(dim=-1) / ((e_noise ** 2).sum(dim=-1) + eps)
        + eps)
    return -snr.mean()


def complex_mag_mse(predict: torch.Tensor, target: torch.Tensor,
                    ref_mag_bug: bool = False):
    """(cpx-MSE, mag-MSE), each summed over freq then meaned over (B, T).

    predict/target: (B, F, T, 2). ref_mag_bug reproduces the reference's
    target magnitude computed from the real part twice
    (pretrain_pvaes_loss.py:192: ``sqrt(re^2 + re^2)``); off by default.
    """
    pr, pi = predict[..., 0], predict[..., 1]
    tr, ti = target[..., 0], target[..., 1]
    p_mag = torch.sqrt(pr * pr + pi * pi + 1e-6)
    if ref_mag_bug:
        t_mag = torch.sqrt(tr * tr + tr * tr + 1e-6)
    else:
        t_mag = torch.sqrt(tr * tr + ti * ti + 1e-6)
    loss_cpx = (((pr - tr) ** 2).sum(dim=1)
                + ((pi - ti) ** 2).sum(dim=1)).mean()
    loss_mag = ((p_mag - t_mag) ** 2).sum(dim=1).mean()
    return loss_cpx, loss_mag


def multiple_recon_loss(predict_spec: torch.Tensor, target_spec: torch.Tensor,
                        source: torch.Tensor, est_source: torch.Tensor,
                        weights: Sequence[float] = (1.0, 1.0, 1.0),
                        ref_mag_bug: bool = False):
    """w0*cpx-MSE + w1*mag-MSE + w2*SI-SNR (the 'multiple' recon loss).

    Returns (total, loss_cpx, loss_mag, loss_sisnr).
    """
    loss_cpx, loss_mag = complex_mag_mse(predict_spec, target_spec,
                                         ref_mag_bug)
    loss_sisnr = si_snr_loss(source, est_source)
    total = (weights[0] * loss_cpx + weights[1] * loss_mag
             + weights[2] * loss_sisnr)
    return total, loss_cpx, loss_mag, loss_sisnr


def prob_recon_loss(predict_spec: torch.Tensor,
                    target_spec: torch.Tensor) -> torch.Tensor:
    """MSE on the decoder-mean spectrogram ('prob' recon type): squared
    error summed over freq, meaned over (B, T)."""
    pr, pi = predict_spec[..., 0], predict_spec[..., 1]
    tr, ti = target_spec[..., 0], target_spec[..., 1]
    return ((pr - tr) ** 2 + (pi - ti) ** 2).sum(dim=1).mean()
