"""Secondary NSVAE-loss variants (nsvae_loss.py research surface).

The port of `idccrn_vae_tpu/losses/nsvae_variants.py`, with the same
functions, classes and return tuples; like the JAX package's, no trainer
or CLI calls them.

  * NsvaeSamplingKlLoss — KL estimated by the sampled log-prob ratio
    E_{z~q1}[log q1(z) - log q2(z)] instead of the closed form
    (standard_nsvae_loss_by_sampling, nsvae_loss.py:5-239); total is
    w_kl*kl + w_resi*residual.
  * NsvaeWithDecoderReconLoss — joint KL + CVAE-decoder reconstruction
    (nsvae_loss_with_cvae_decoder_recon, :474-613).
  * EteWithLatentLoss — end-to-end SE recon + latent KL
    (ete_train_se_with_latent_loss, :617-751; latent_num=1 form:
    kl = mean KL(q_noisy||q_clean) - alpha * mean KL(q_noisy||q_noise)).
"""

from __future__ import annotations

from typing import Sequence

import torch

from idccrn_vae_torch.losses.complex_gaussian import (
    complex_gaussian_log_prob,
    complex_kl_divergence,
)
from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
from idccrn_vae_torch.losses.recon import multiple_recon_loss
from idccrn_vae_torch.models.reparam import CGauss


def _split_samples(z: torch.Tensor, b: int):
    """cpack (B*S, T, H*2) -> (z_r, z_i) each (B, S, T, H)."""
    zr, zi = z.chunk(2, dim=-1)
    s = zr.shape[0] // b
    t, h = zr.shape[1], zr.shape[2]
    return zr.reshape(b, s, t, h), zi.reshape(b, s, t, h)


def sampled_kl(g1: CGauss, g2: CGauss, z1: torch.Tensor,
               eps: float = 1e-10) -> torch.Tensor:
    """Monte-Carlo KL over the drawn samples (B, T); z1 ~ q1 cpack."""
    b = g1.mu_r.shape[0]
    zr, zi = _split_samples(z1, b)
    lp1 = complex_gaussian_log_prob(g1, zr, zi, eps)
    lp2 = complex_gaussian_log_prob(g2, zr, zi, eps)
    return (lp1 - lp2).mean(dim=1)


class NsvaeSamplingKlLoss(NsvaeTrueKlLoss):
    """Same structure as the true-KL loss but with the sampled
    estimator; the reference guards log-prob deltas at 0.99 here
    (nsvae_loss.py:58-63) vs 0.90 in the pretrain version — the
    difference is within the guard's inactive region for trained
    models, so the shared implementation is used."""

    def kl_loss(self, g_clean, g_noise, g_ns, g_nn, z_s=None, z_n=None):
        kl_clean = sampled_kl(g_ns, g_clean, z_s, self.eps).mean()
        if self.cfg.latent_num == 1:
            kl_noise = sampled_kl(g_ns, g_noise, z_s, self.eps).mean()
            total = kl_clean - self.alpha * kl_noise
        else:
            kl_noise = sampled_kl(g_nn, g_noise, z_n, self.eps).mean()
            total = kl_clean + self.alpha * kl_noise
        return total, kl_clean, kl_noise

    def __call__(self, g_clean, g_noise, g_noisy_speech, g_noisy_noise,
                 z_speech, z_noise=None, skips_clean=None, skips_noise=None,
                 skips_noisy=None):
        kl, kl_clean, kl_noise = self.kl_loss(
            g_clean, g_noise, g_noisy_speech, g_noisy_noise,
            z_s=z_speech, z_n=z_noise)
        if self.use_skips and self.w_resi != 0 and skips_clean is not None:
            need_noise = self.cfg.latent_num == 2 and self.matching == "both"
            if skips_noisy is None or (need_noise and skips_noise is None):
                raise ValueError(
                    "residual matching needs skips_noisy"
                    + (" and skips_noise (matching='both', latent_num=2)"
                       if need_noise else "")
                    + " alongside skips_clean; got None")
            resi, resi_s, resi_n = self.residual_loss(
                skips_clean, skips_noise, skips_noisy)
            total = self.w_kl * kl + self.w_resi * resi
        else:
            resi = resi_s = resi_n = kl.new_zeros(())
            total = self.w_kl * kl
        return total, kl, kl_clean, kl_noise, resi, resi_s, resi_n


class NsvaeWithDecoderReconLoss:
    """KL (per-latent weights) + w_recon * decoder reconstruction."""

    def __init__(self, w_kl_noise: float, w_kl_speech: float, w_recon: float,
                 recon_loss_weight: Sequence[float], latent_num: int):
        self.w_kl_noise = float(w_kl_noise)
        self.w_kl_speech = float(w_kl_speech)
        self.w_recon = float(w_recon)
        self.recon_loss_weight = tuple(recon_loss_weight)
        self.latent_num = latent_num
        self.eps = 1e-10

    def kl_loss(self, g_clean, g_noise, g_ns, g_nn):
        kl_clean = complex_kl_divergence(g_ns, g_clean, self.eps).mean()
        if self.latent_num == 1:
            kl_noise = complex_kl_divergence(g_ns, g_noise, self.eps).mean()
            total = (self.w_kl_speech * kl_clean
                     - self.w_kl_noise * kl_noise)
        else:
            kl_noise = complex_kl_divergence(g_nn, g_noise, self.eps).mean()
            total = (self.w_kl_speech * kl_clean
                     + self.w_kl_noise * kl_noise)
        return total, kl_clean, kl_noise

    def __call__(self, g_clean, g_noise, g_noisy_speech, g_noisy_noise,
                 predict_spec, target_spec, source, est_source):
        kl, kl_clean, kl_noise = self.kl_loss(
            g_clean, g_noise, g_noisy_speech, g_noisy_noise)
        recon, l_cpx, l_mag, l_snr = multiple_recon_loss(
            predict_spec, target_spec, source, est_source,
            self.recon_loss_weight)
        total = kl + self.w_recon * recon
        return total, kl, kl_clean, kl_noise, recon, l_cpx, l_mag, l_snr


class EteWithLatentLoss:
    """End-to-end SE loss + alpha-weighted latent KL."""

    def __init__(self, kl_weight: float,
                 recon_loss_weight: Sequence[float], alpha: float):
        self.kl_weight = float(kl_weight)
        self.recon_loss_weight = tuple(recon_loss_weight)
        self.alpha = float(alpha)
        self.eps = 1e-10

    def __call__(self, g_clean: CGauss, g_noise: CGauss,
                 g_noisy_speech: CGauss, predict_spec, target_spec,
                 source, est_source):
        kl_clean = complex_kl_divergence(g_noisy_speech, g_clean,
                                         self.eps).mean()
        kl_noise = complex_kl_divergence(g_noisy_speech, g_noise,
                                         self.eps).mean()
        kl = kl_clean - self.alpha * kl_noise
        recon, l_cpx, l_mag, l_snr = multiple_recon_loss(
            predict_spec, target_spec, source, est_source,
            self.recon_loss_weight)
        total = recon + self.kl_weight * kl
        return total, kl, kl_clean, kl_noise, recon, l_cpx, l_mag, l_snr
