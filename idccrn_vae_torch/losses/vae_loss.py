"""Pretrain VAE loss: recon + warmed KL - MI (complex_standard_vae_loss).

Mirrors `idccrn_vae_tpu/losses/vae_loss.py` (pretrain_pvaes_loss.py:
48-347): 'multiple' or 'prob' recon, closed-form KL against a standard
('ri_inde') or correlated ('ri_corr') complex-Gaussian prior, the
optional minibatch MI regularizer and the cyclical linear KL warmup
(Fu et al. 2019).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from idccrn_vae_torch.losses.complex_gaussian import (
    complex_kl_divergence,
    mutual_information,
    standard_prior_like,
)
from idccrn_vae_torch.losses.recon import multiple_recon_loss, prob_recon_loss
from idccrn_vae_torch.models.reparam import CGauss


def kl_annealing_schedule(n_epochs: int, start: float = 0.0,
                          stop: float = 1.0, n_cycle: int = 1,
                          ratio: float = 1.0) -> np.ndarray:
    """Cyclical linear beta schedule (pretrain_pvaes_loss.py:10-42)."""
    sched = np.full(n_epochs, stop, dtype=np.float64)
    period = n_epochs / n_cycle
    step = (stop - start) / (period * ratio)
    for c in range(n_cycle):
        v, i = start, 0
        while v <= stop and int(i + c * period) < n_epochs:
            sched[int(i + c * period)] = v
            v += step
            i += 1
    return sched.astype(np.float32)


class VaeLossOut(NamedTuple):
    total: torch.Tensor
    recon: torch.Tensor
    kl: torch.Tensor
    mi: torch.Tensor
    loss_cpx: torch.Tensor
    loss_mag: torch.Tensor
    loss_sisnr: torch.Tensor


class PretrainVaeLoss:
    def __init__(self, kl_warm_weights: np.ndarray, kl_weight: float,
                 mi_weight: float = 0.0, recon_loss_type: str = "multiple",
                 recon_loss_weight: Sequence[float] = (1.0, 1.0, 1.0),
                 num_samples: int = 5, prior_mode: str = "ri_inde",
                 ref_mag_bug: bool = False):
        """ref_mag_bug: reproduce the reference's target-magnitude slip
        (pretrain_pvaes_loss.py:192); off by default."""
        self.kl_warm_weights = np.asarray(kl_warm_weights, np.float32)
        self.kl_warm_epochs = len(self.kl_warm_weights)
        self.kl_weight = float(kl_weight)
        self.mi_weight = float(mi_weight)
        self.recon_loss_type = recon_loss_type
        self.recon_loss_weight = tuple(recon_loss_weight)
        self.num_samples = num_samples
        self.prior_mode = prior_mode
        self.ref_mag_bug = bool(ref_mag_bug)
        self.eps = 1e-9

    def kl_weight_at(self, epoch: int) -> float:
        """The warmed KL weight of an epoch."""
        if epoch < self.kl_warm_epochs:
            return float(self.kl_warm_weights[epoch])
        return self.kl_weight

    def __call__(self, source: torch.Tensor, est_source: torch.Tensor,
                 stft_source: torch.Tensor, predict_spec: torch.Tensor,
                 gauss: CGauss, z: torch.Tensor, kl_w: float) -> VaeLossOut:
        """source/est_source (B*S, L); stft_source/predict_spec
        (B*S, F, T, 2); z (B*S, T, 2*zdim) cpack samples; kl_w the
        warmed KL weight."""
        zero = source.new_zeros(())
        if self.recon_loss_type == "multiple":
            recon, l_cpx, l_mag, l_snr = multiple_recon_loss(
                predict_spec, stft_source, source, est_source,
                self.recon_loss_weight, ref_mag_bug=self.ref_mag_bug)
        else:
            recon = prob_recon_loss(predict_spec, stft_source)
            l_cpx = l_mag = l_snr = zero

        prior = standard_prior_like(gauss, self.prior_mode)
        kl = complex_kl_divergence(gauss, prior, eps=self.eps).mean()

        if self.mi_weight != 0.0:
            b, t, h = gauss.mu_r.shape
            zr, zi = z.chunk(2, dim=-1)
            mi = mutual_information(
                gauss, zr.reshape(b, self.num_samples, t, h),
                zi.reshape(b, self.num_samples, t, h), eps=self.eps)
        else:
            mi = zero

        total = recon + kl_w * kl - self.mi_weight * mi
        return VaeLossOut(total, recon, kl, mi, l_cpx, l_mag, l_snr)
