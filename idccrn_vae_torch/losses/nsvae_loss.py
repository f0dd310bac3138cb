"""NSVAE posterior-matching loss (standard_nsvae_loss_true_kl).

Mirrors `idccrn_vae_tpu/losses/nsvae_loss.py` (nsvae_loss.py:243-473):
closed-form KL between the noisy encoder's posterior(s) and the frozen
clean/noise posteriors —
  latent_num=1:  mean KL(q_noisy||q_clean) - alpha * mean KL(q_noisy||q_noise)
  latent_num=2:  KL_speech + alpha * KL_noise
plus the mu-distance loss and the skip-residual matching loss. As in the
JAX package, the residual term is reported but not part of `total`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from idccrn_vae_torch.losses.complex_gaussian import complex_kl_divergence
from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.models.nsvae import split_noisy_skips
from idccrn_vae_torch.models.reparam import CGauss
from idccrn_vae_torch.parallel import distributed


class NsvaeLossOut(NamedTuple):
    total: torch.Tensor
    kl: torch.Tensor
    kl_clean: torch.Tensor
    kl_noise: torch.Tensor
    dismiu_speech: torch.Tensor
    dismiu_noise: torch.Tensor
    resi: torch.Tensor
    resi_speech: torch.Tensor
    resi_noise: torch.Tensor


def miu_distance(g_a: CGauss, g_b: CGauss) -> torch.Tensor:
    """sqrt(sum_dim mean_{B,T} (mu_a - mu_b)^2) over (re, im) stacked
    (nsvae_loss.py:349-360). The mean spans the global batch in a
    data-parallel group: the square root makes it no batch mean of
    per-row values, so local means would not average to it."""
    d_r, d_i = distributed.batch_means(
        [(g_a.mu_r - g_b.mu_r) ** 2, (g_a.mu_i - g_b.mu_i) ** 2], (0, 1))
    return torch.sqrt(d_r.sum() + d_i.sum())


class NsvaeTrueKlLoss:
    def __init__(self, alpha: float, w_resi: float, w_kl: float,
                 w_dismiu: float, cfg: DccrnConfig, matching: str = "speech",
                 use_skips: bool = True):
        self.alpha = float(alpha)
        self.w_resi = float(w_resi)
        self.w_kl = float(w_kl)
        self.w_dismiu = float(w_dismiu)
        self.cfg = cfg
        self.matching = matching
        self.use_skips = use_skips
        self.eps = 1e-10

    def kl_loss(self, g_clean, g_noise, g_ns, g_nn):
        kl_clean = complex_kl_divergence(g_ns, g_clean, self.eps).mean()
        if self.cfg.latent_num == 1:
            kl_noise = complex_kl_divergence(g_ns, g_noise, self.eps).mean()
            total = kl_clean - self.alpha * kl_noise
        else:
            kl_noise = complex_kl_divergence(g_nn, g_noise, self.eps).mean()
            total = kl_clean + self.alpha * kl_noise
        return total, kl_clean, kl_noise

    def residual_loss(self, skips_clean, skips_noise, skips_noisy):
        """Mean-squared skip matching at the skip_to_use stages (skip i
        matches when (num_stages-1-i) is in skip_to_use). The speech /
        noise half-split of the noisy skips is `split_noisy_skips`, the
        convention the decoders consume."""
        n = self.cfg.num_stages
        ref = skips_clean[0]
        loss_speech = ref.new_zeros((), dtype=torch.float32)
        loss_noise = ref.new_zeros((), dtype=torch.float32)
        match_noise = self.cfg.latent_num == 2 and self.matching == "both"
        sp = split_noisy_skips(skips_noisy, self.cfg, "speech")
        no = (split_noisy_skips(skips_noisy, self.cfg, "noise")
              if match_noise else None)
        for i in range(n):
            if (n - 1 - i) not in self.cfg.skip_to_use:
                continue
            loss_speech = loss_speech + ((skips_clean[i] - sp[i]) ** 2).mean()
            if match_noise:
                loss_noise = loss_noise + ((skips_noise[i] - no[i]) ** 2
                                           ).mean()
        return loss_speech + loss_noise, loss_speech, loss_noise

    def __call__(self, g_clean: CGauss, g_noise: CGauss,
                 g_noisy_speech: CGauss, g_noisy_noise: Optional[CGauss],
                 skips_clean: Optional[Sequence] = None,
                 skips_noise: Optional[Sequence] = None,
                 skips_noisy: Optional[Sequence] = None) -> NsvaeLossOut:
        kl, kl_clean, kl_noise = self.kl_loss(g_clean, g_noise,
                                              g_noisy_speech, g_noisy_noise)
        dismiu_speech = miu_distance(g_clean, g_noisy_speech)
        # latent_num=1: the reference compares the noise posterior with
        # the single noisy latent (nsvae_loss.py:355)
        dismiu_noise = miu_distance(
            g_noise, g_noisy_noise if g_noisy_noise is not None
            else g_noisy_speech)
        dismiu = dismiu_speech + dismiu_noise

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
        else:
            resi = resi_s = resi_n = kl.new_zeros(())

        total = self.w_kl * kl + self.w_dismiu * dismiu
        return NsvaeLossOut(total, kl, kl_clean, kl_noise, dismiu_speech,
                            dismiu_noise, resi, resi_s, resi_n)
