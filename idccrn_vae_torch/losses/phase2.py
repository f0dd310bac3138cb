"""Phase-2 decoder fine-tuning losses and the supervised DCCRN loss.

The port of `idccrn_vae_tpu/losses/phase2.py`:

  * EteTrainSeLoss    — supervised baseline: weighted cpx-MSE + mag-MSE
                        + SI-SNR (nsvae_loss.py:755-806).
  * TwoPhaseLoss      — classical fine-tune: recon on the clean (and
                        optionally the noise) decoder's outputs, plus the
                        phase-1 KL variant (nsvae_loss.py:809-948).
  * AdversarialPhase2Loss — LSGAN: D: (D(clean)-1)^2 + D(est)^2;
                        G: 0.5*(D(est)-1)^2 + SI-SNR
                        (nsvae_loss.py:953-986).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from idccrn_vae_torch.losses.complex_gaussian import complex_kl_divergence
from idccrn_vae_torch.losses.recon import multiple_recon_loss, si_snr_loss
from idccrn_vae_torch.models.reparam import CGauss


class EteTrainSeLoss:
    """Supervised DCCRN loss (no KL). Returns (total, cpx, mag, sisnr)."""

    def __init__(self, recon_loss_weight: Sequence[float]):
        self.weights = tuple(recon_loss_weight)

    def __call__(self, predict_spec, target_spec, source, est_source):
        return multiple_recon_loss(predict_spec, target_spec, source,
                                   est_source, self.weights)


class TwoPhaseOut(NamedTuple):
    total: torch.Tensor
    cpx_clean: torch.Tensor
    mag_clean: torch.Tensor
    sisnr_clean: torch.Tensor
    cpx_noise: torch.Tensor
    mag_noise: torch.Tensor
    sisnr_noise: torch.Tensor


class TwoPhaseLoss:
    def __init__(self, recon_loss_weight: Sequence[float], alpha: float,
                 latent_num: int, ref_mag_bug: bool = False):
        """ref_mag_bug: reproduce the reference's target magnitude
        computed from the real part twice (nsvae_loss.py:899); off by
        default."""
        self.weights = tuple(recon_loss_weight)
        self.alpha = float(alpha)
        self.latent_num = latent_num
        self.ref_mag_bug = ref_mag_bug
        self.eps = 1e-10

    def phase_2_loss(self, predict_clean, stft_clean, clean_wav, recon_clean,
                     predict_noise=None, stft_noise=None, noise_wav=None,
                     recon_noise=None) -> TwoPhaseOut:
        tot_c, cpx_c, mag_c, snr_c = multiple_recon_loss(
            predict_clean, stft_clean, clean_wav, recon_clean, self.weights,
            ref_mag_bug=self.ref_mag_bug)
        if self.latent_num == 2 and predict_noise is not None:
            tot_n, cpx_n, mag_n, snr_n = multiple_recon_loss(
                predict_noise, stft_noise, noise_wav, recon_noise,
                self.weights, ref_mag_bug=self.ref_mag_bug)
            total = tot_c + tot_n
        else:
            cpx_n = mag_n = snr_n = tot_c.new_zeros(())
            total = tot_c
        return TwoPhaseOut(total, cpx_c, mag_c, snr_c, cpx_n, mag_n, snr_n)

    def phase_1_loss(self, g_clean: CGauss, g_noise: CGauss,
                     g_noisy_speech: CGauss,
                     g_noisy_noise: Optional[CGauss]):
        """The KL variant the reference keeps (nsvae_loss.py:931-948);
        latent_num 2 weighs the noise KL by 1. Returns (total, kl_clean,
        kl_noise)."""
        kl_clean = complex_kl_divergence(g_noisy_speech, g_clean,
                                         self.eps).mean()
        if self.latent_num == 1:
            kl_noise = complex_kl_divergence(g_noisy_speech, g_noise,
                                             self.eps).mean()
            total = kl_clean - self.alpha * kl_noise
        else:
            kl_noise = complex_kl_divergence(g_noisy_noise, g_noise,
                                             self.eps).mean()
            total = kl_clean + kl_noise
        return total, kl_clean, kl_noise


class AdversarialPhase2Loss:
    def __init__(self, latent_num: int = 1):
        self.latent_num = latent_num

    def discriminator_loss(self, dis_true_clean, dis_est_clean):
        """LSGAN D objective: (D(x)-1)^2 + D(G(z))^2, per-frame mean."""
        return ((dis_true_clean - 1.0) ** 2 + dis_est_clean ** 2).mean()

    def generator_loss(self, true_clean, est_clean, dis_est_clean):
        """G objective: 0.5*(D(est)-1)^2 + SI-SNR(clean, est). Returns
        (total, SI-SNR loss, D term)."""
        loss_recon = si_snr_loss(true_clean, est_clean)
        loss_dis = ((dis_est_clean - 1.0) ** 2).mean()
        return 0.5 * loss_dis + loss_recon, loss_recon, loss_dis
