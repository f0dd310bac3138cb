"""Secondary pretrain-loss variants from the reference loss zoo.

The port of `idccrn_vae_tpu/losses/vae_variants.py`, with the same
functions, classes and return tuples. None of these is wired into an
entry script, in the reference or in either package; they are part of
its research surface (pretrain_pvaes_loss.py):

  * EstLikelihoodVaeLoss — decoder output treated probabilistically:
    recon = -E[log N(spec | mu_x, sigma_x, delta_x)] (:351-567).
  * VcaeLoss — mu-free KL against a prior over (sigma, delta) only,
    with configurable prior variance pz_sigma (:572-879).
  * VcaeRegmiuLoss — VCAE + covariance regularizer on mu across the
    batch (loss_opt 1: averaged diag/offdiag, 2: elementwise) (:884-1194).
  * DipVaeLoss — DIP-VAE-style cov(mu) regularizer, the reference's
    "loss 6" form with a Vri-diagonal target (:1198-1556).

All compose the shared primitives in complex_gaussian.py / recon.py.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from idccrn_vae_torch.losses.complex_gaussian import (
    _guard_delta,
    _log_density_core,
    complex_kl_divergence,
    mutual_information,
    standard_prior_like,
)
from idccrn_vae_torch.losses.recon import multiple_recon_loss, prob_recon_loss
from idccrn_vae_torch.models.reparam import CGauss


def mu_free_kl(g1: CGauss, g2: CGauss, eps: float = 1e-9) -> torch.Tensor:
    """KL restricted to the covariance terms (no mu quadratic) — the
    VCAE cal_kl_arbi_prior (pretrain_pvaes_loss.py:758-815). (B, T)."""
    zdim = g1.log_sigma.shape[-1]
    s1, s2 = torch.exp(g1.log_sigma), torch.exp(g2.log_sigma)
    d1r, d1i, abs_d1 = _guard_delta(s1, g1.delta_r, g1.delta_i, eps, 0.99)
    d2r, d2i, abs_d2 = _guard_delta(s2, g2.delta_r, g2.delta_i, eps, 0.99)
    log_det_c1 = torch.log(0.25 * (s1 * s1 - abs_d1) + eps)
    log_det_c2 = torch.log(0.25 * (s2 * s2 - abs_d2) + eps)
    coeff = 2.0 / (s2 * s2 - abs_d2 + eps)
    trace_term = s1 * s2 - d2r * d1r - d2i * d1i
    return 0.5 * (coeff * trace_term + log_det_c2 - log_det_c1).sum(
        dim=-1) - zdim


def mu_covariance_parts(mu_r: torch.Tensor, mu_i: torch.Tensor):
    """cov of the stacked (re, im) latent means over (B*T) latents
    -> (cov (2H,2H), diag (2H,), offdiag (2H,2H))."""
    b, t, h = mu_r.shape
    v = torch.cat([mu_r.reshape(b * t, h), mu_i.reshape(b * t, h)], dim=1)
    v = v - v.mean(dim=0, keepdim=True)
    cov = v.T @ v / (b * t)
    diag = torch.diagonal(cov)
    off = cov - torch.diag(diag)
    return cov, diag, off


def _mi(gauss: CGauss, z: torch.Tensor, num_samples: int) -> torch.Tensor:
    """The MI term of a (B*S, T, 2H) cpack sample batch."""
    b, t, h = gauss.mu_r.shape
    zr, zi = z.chunk(2, dim=-1)
    return mutual_information(gauss, zr.reshape(b, num_samples, t, h),
                              zi.reshape(b, num_samples, t, h))


class EstLikelihoodVaeLoss:
    """Probabilistic-decoder pretrain loss ('prob' recon only)."""

    def __init__(self, kl_warm_weights, kl_weight, mi_weight=0.0,
                 num_samples=5, prior_mode="ri_inde"):
        self.kl_warm_weights = np.asarray(kl_warm_weights, np.float32)
        self.kl_warm_epochs = len(self.kl_warm_weights)
        self.kl_weight = float(kl_weight)
        self.mi_weight = float(mi_weight)
        self.num_samples = num_samples
        self.prior_mode = prior_mode
        self.eps = 1e-10

    def kl_weight_at(self, epoch: int) -> float:
        if epoch < self.kl_warm_epochs:
            return float(self.kl_warm_weights[epoch])
        return self.kl_weight

    def recon_log_likelihood(self, g_x: CGauss, target: torch.Tensor):
        """g_x fields (B, S, T, F) — per-sample decoder distribution;
        target (B, F, T, 2). Returns (-mean log prob, mean cpx err)."""
        eps = 1e-10
        tr = target[..., 0].transpose(1, 2)[:, None]  # (B,1,T,F)
        ti = target[..., 1].transpose(1, 2)[:, None]
        sigma = torch.exp(g_x.log_sigma)
        dr, di, _ = _guard_delta(sigma, g_x.delta_r, g_x.delta_i, eps, 0.90)
        zr = tr - g_x.mu_r
        zi = ti - g_x.mu_i
        log_prob = _log_density_core(sigma, dr, di, zr, zi, eps)
        loss_cpx = (zr * zr + zi * zi).sum(dim=-1).mean()
        return -log_prob.mean(), loss_cpx

    def __call__(self, g_x: CGauss, target_spec, gauss: CGauss, z, kl_w):
        recon, loss_cpx = self.recon_log_likelihood(g_x, target_spec)
        prior = standard_prior_like(gauss, self.prior_mode)
        kl = complex_kl_divergence(gauss, prior, eps=self.eps).mean()
        mi = (_mi(gauss, z, self.num_samples) if self.mi_weight != 0.0
              else recon.new_zeros(()))
        total = recon + kl_w * kl - self.mi_weight * mi
        return total, recon, kl, mi, loss_cpx


class VcaeLoss:
    """mu-free KL pretrain loss (prior variance pz_sigma)."""

    def __init__(self, kl_weight, mi_weight=0.0, recon_loss_type="multiple",
                 recon_loss_weight: Sequence[float] = (1.0, 1.0, 0.0),
                 num_samples=5, prior_mode="ri_inde", pz_sigma=1.0):
        self.kl_weight = float(kl_weight)
        self.mi_weight = float(mi_weight)
        self.recon_loss_type = recon_loss_type
        self.recon_loss_weight = tuple(recon_loss_weight)
        self.num_samples = num_samples
        self.prior_mode = prior_mode
        self.pz_sigma = float(pz_sigma)
        self.eps = 1e-9

    def _prior(self, gauss: CGauss) -> CGauss:
        log_s = torch.full_like(gauss.log_sigma, math.log(self.pz_sigma))
        zeros = torch.zeros_like(gauss.mu_r)
        # ri_corr quirk: the reference sets delta_i prior to
        # log(pz_sigma) (pretrain_pvaes_loss.py:869) — reproduced.
        delta_i = (torch.full_like(zeros, math.log(self.pz_sigma))
                   if self.prior_mode == "ri_corr" else zeros)
        return CGauss(zeros, zeros, log_s, zeros, delta_i)

    def _recon(self, predict_spec, target_spec, source, est_source):
        if self.recon_loss_type == "multiple":
            return multiple_recon_loss(predict_spec, target_spec, source,
                                       est_source, self.recon_loss_weight)
        loss = prob_recon_loss(predict_spec, target_spec)
        z = loss.new_zeros(())
        return loss, z, z, z

    def __call__(self, source, est_source, target_spec, predict_spec,
                 gauss: CGauss, z):
        recon, l_cpx, l_mag, l_snr = self._recon(predict_spec, target_spec,
                                                 source, est_source)
        kl = mu_free_kl(gauss, self._prior(gauss), self.eps).mean()
        mi = (_mi(gauss, z, self.num_samples) if self.mi_weight != 0.0
              else recon.new_zeros(()))
        total = recon + self.kl_weight * kl - self.mi_weight * mi
        return total, recon, kl, mi, l_cpx, l_mag, l_snr


class VcaeRegmiuLoss(VcaeLoss):
    """VCAE + cov(mu) regularizer (loss_opt 1: averaged, 2: elementwise)."""

    def __init__(self, *args, loss_opt=1, regmiu_w=1.0, miu_sigma=1.0,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.loss_opt = loss_opt
        self.regmiu_w = float(regmiu_w)
        self.miu_sigma = float(miu_sigma)

    def miu_regu_loss(self, gauss: CGauss):
        _cov, diag, off = mu_covariance_parts(gauss.mu_r, gauss.mu_i)
        if self.loss_opt == 1:
            diag_loss = (diag.mean() - self.miu_sigma) ** 2
            off_loss = off.mean() ** 2
        else:
            diag_loss = ((diag - self.miu_sigma) ** 2).mean()
            off_loss = (off ** 2).mean()
        # the reference weights offdiag by 0 (pretrain_pvaes_loss.py:1155)
        return self.regmiu_w * diag_loss, off_loss, diag_loss

    def __call__(self, source, est_source, target_spec, predict_spec,
                 gauss: CGauss, z):
        out = super().__call__(source, est_source, target_spec, predict_spec,
                               gauss, z)
        total, recon, kl, mi, l_cpx, l_mag, l_snr = out
        regu, off_loss, diag_loss = self.miu_regu_loss(gauss)
        return (total + regu, recon, kl, off_loss, diag_loss, mi,
                l_cpx, l_mag, l_snr)


class DipVaeLoss:
    """Standard-KL pretrain loss + DIP cov(mu) regularizer ('loss 6':
    averaged-diag target + |Vri| diagonal target + offdiag suppression,
    pretrain_pvaes_loss.py:1496-1520)."""

    def __init__(self, kl_weight, mi_weight=0.0, off_weight=1.0,
                 diag_weight=1.0,
                 recon_loss_weight: Sequence[float] = (1.0, 1.0, 0.0),
                 recon_loss_type="multiple", num_samples=5,
                 prior_mode="ri_inde", miu_sigma=1.0):
        self.kl_weight = float(kl_weight)
        self.mi_weight = float(mi_weight)
        self.off_weight = float(off_weight)
        self.diag_weight = float(diag_weight)
        self.recon_loss_weight = tuple(recon_loss_weight)
        self.recon_loss_type = recon_loss_type
        self.num_samples = num_samples
        self.prior_mode = prior_mode
        self.miu_sigma = float(miu_sigma)
        self.eps = 1e-9

    def miu_regu_loss(self, gauss: CGauss):
        _cov, diag, off = mu_covariance_parts(gauss.mu_r, gauss.mu_i)
        h = gauss.mu_r.shape[-1]
        diag_loss = torch.sqrt(torch.clamp(
            (diag.mean() - self.miu_sigma) ** 2, min=1e-8))
        vri_diag = torch.diagonal(off[:h, h:])
        vri_loss = torch.sqrt(torch.clamp(
            (vri_diag.abs().mean() - self.miu_sigma) ** 2, min=1e-8))
        diag_loss = 0.5 * (diag_loss + vri_loss)
        # zero the cross-block diagonals before the offdiag penalty
        eye = torch.eye(h, dtype=off.dtype, device=off.device)
        mask = torch.ones_like(off)
        mask[:h, h:] = 1.0 - eye
        mask[h:, :h] = 1.0 - eye
        off_m = off * mask
        off_loss = torch.sqrt(torch.clamp(off_m ** 2, min=1e-8).mean())
        regu = self.off_weight * off_loss + self.diag_weight * diag_loss
        return regu, off_loss, diag_loss

    def __call__(self, source, est_source, target_spec, predict_spec,
                 gauss: CGauss, z):
        if self.recon_loss_type == "multiple":
            recon, l_cpx, l_mag, l_snr = multiple_recon_loss(
                predict_spec, target_spec, source, est_source,
                self.recon_loss_weight)
        else:
            recon = prob_recon_loss(predict_spec, target_spec)
            l_cpx = l_mag = l_snr = recon.new_zeros(())
        prior = standard_prior_like(gauss, self.prior_mode)
        kl = complex_kl_divergence(gauss, prior, eps=self.eps).mean()
        mi = (_mi(gauss, z, self.num_samples) if self.mi_weight != 0.0
              else recon.new_zeros(()))
        regu, off_loss, diag_loss = self.miu_regu_loss(gauss)
        total = recon + self.kl_weight * kl + regu - self.mi_weight * mi
        return (total, recon, kl, off_loss, diag_loss, mi, l_cpx, l_mag,
                l_snr)
