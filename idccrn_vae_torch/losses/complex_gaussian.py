"""Complex-Gaussian density and KL, the latent-space math of the losses.

Mirrors `idccrn_vae_tpu/losses/complex_gaussian.py`: the
complex-Gaussian log-likelihood (pretrain_pvaes_loss.py:64-128), the
closed-form KL between complex Gaussians with pseudo-covariance
(pretrain_pvaes_loss.py:225-281) and the minibatch mutual-information
estimator (pretrain_pvaes_loss.py:129-158).

A 1-D complex Gaussian with variance sigma (real) and pseudo-covariance
delta (complex, |delta| < sigma) has covariance of the stacked real
2-vector:  C = 0.5 * [[sigma+Re d, Im d], [Im d, sigma-Re d]].
"""

from __future__ import annotations

import math

import torch

from idccrn_vae_torch.models.reparam import CGauss, project_delta
from idccrn_vae_torch.parallel import distributed


def standard_prior_like(g: CGauss, prior_mode: str = "ri_inde") -> CGauss:
    """N(0, I) prior ('ri_inde') or the correlated prior with
    delta_i = 1 ('ri_corr') — pretrain_pvaes_loss.py:322-331."""
    zeros = torch.zeros_like(g.mu_r)
    delta_i = torch.ones_like(g.mu_r) if prior_mode == "ri_corr" else zeros
    return CGauss(mu_r=zeros, mu_i=zeros, log_sigma=zeros,
                  delta_r=zeros, delta_i=delta_i)


def _guard_delta(sigma, dr, di, eps, factor):
    """|delta| <= factor*sigma projection: `models/reparam.project_delta`,
    the one copy that sampling and the density math share."""
    dr, di = project_delta(sigma, dr, di, eps=eps, factor=factor)
    return dr, di, dr * dr + di * di


def _log_density_core(sigma, dr, di, zr, zi, eps):
    """log q(z) up to the constant -H*log(pi), reduced over the last
    (latent) axis. All args pre-guarded and mutually broadcastable;
    zr/zi are already mean-centred."""
    abs_d = dr * dr + di * di
    p = sigma - abs_d / (sigma + eps)
    reci_p = 1.0 / (p + eps)
    rp_r = dr / (sigma * p + eps)
    rp_i = -di / (sigma * p + eps)
    p_1_minus = reci_p - abs_d / (sigma * p * sigma + eps)
    log_det = torch.log(p_1_minus + eps).sum(dim=-1)
    log_1_over_p = torch.log(reci_p + eps).sum(dim=-1)
    quad = -((zr * zr + zi * zi) * reci_p).sum(dim=-1)
    real_part = ((zr * zr - zi * zi) * rp_r
                 - 2.0 * zr * zi * rp_i).sum(dim=-1)
    return 0.5 * (log_det + log_1_over_p) + real_part + quad


def complex_kl_divergence(g1: CGauss, g2: CGauss,
                          eps: float = 1e-10) -> torch.Tensor:
    """KL(q1 || q2) per (batch, time), summed over latent dims, with the
    reference's ``- zdim`` normalization and epsilon placement. Inputs
    (B, T, H); output (B, T)."""
    zdim = g1.mu_r.shape[-1]
    s1 = torch.exp(g1.log_sigma)
    s2 = torch.exp(g2.log_sigma)
    d1r, d1i, abs_d1 = _guard_delta(s1, g1.delta_r, g1.delta_i, eps, 0.99)
    d2r, d2i, abs_d2 = _guard_delta(s2, g2.delta_r, g2.delta_i, eps, 0.99)

    log_det_c1 = torch.log(0.25 * (s1 * s1 - abs_d1) + eps)
    log_det_c2 = torch.log(0.25 * (s2 * s2 - abs_d2) + eps)
    coeff = 2.0 / (s2 * s2 - abs_d2 + eps)
    trace_term = s1 * s2 - d2r * d1r - d2i * d1i
    mdr = g2.mu_r - g1.mu_r
    mdi = g2.mu_i - g1.mu_i
    quad = (mdr * mdr * (s2 - d2r) - 2.0 * d2i * mdr * mdi
            + mdi * mdi * (s2 + d2r))
    return 0.5 * (coeff * (trace_term + quad) + log_det_c2
                  - log_det_c1).sum(dim=-1) - zdim


def complex_gaussian_log_prob(g: CGauss, z_r: torch.Tensor,
                              z_i: torch.Tensor,
                              eps: float = 1e-9) -> torch.Tensor:
    """log q(z | g) up to the constant -H*log(pi), per (batch, sample,
    time), with the reference's 0.90 delta-guard factor. g fields are
    (B, T, H); z_r/z_i are (B, S, T, H). Returns (B, S, T)."""
    sigma = torch.exp(g.log_sigma)
    dr, di, _ = _guard_delta(sigma, g.delta_r, g.delta_i, eps, 0.90)
    zr = z_r - g.mu_r[:, None]
    zi = z_i - g.mu_i[:, None]
    return _log_density_core(sigma[:, None], dr[:, None], di[:, None],
                             zr, zi, eps)


def mutual_information(g: CGauss, z_r: torch.Tensor, z_i: torch.Tensor,
                       eps: float = 1e-9) -> torch.Tensor:
    """Minibatch MI estimator I(x; z). z_r/z_i: (B, S, T, H).

    log q(z_i) ~= logsumexp_j log q(z_i | x_j) - log B. The z-batch rows
    are evaluated one at a time against all x posteriors, as the JAX
    package's lax.map does, so each temporary is O(B*S*T*H), not the
    fully broadcast O(B^2*S*T*H).

    In a data-parallel group the z rows are this rank's and the
    aggregate posterior runs over the global batch: the x posteriors are
    gathered from every rank (differentiably) and B is the global count.
    """
    b = z_r.shape[0]
    log_q_zx = complex_gaussian_log_prob(g, z_r, z_i, eps)  # (B, S, T)
    gx = g
    if distributed.active():
        gx = CGauss(*(distributed.gather_rows(t) for t in
                      (g.mu_r, g.mu_i, g.log_sigma, g.delta_r, g.delta_i)))
    sigma = torch.exp(gx.log_sigma)
    dr, di, _ = _guard_delta(sigma, gx.delta_r, gx.delta_i, eps, 0.90)
    s_, dr_, di_ = sigma[:, None], dr[:, None], di[:, None]  # (B_x,1,T,H)
    rows = []
    for k in range(b):                        # one z-batch row (S, T, H)
        zr = z_r[k][None] - gx.mu_r[:, None]  # (B_x, S, T, H)
        zi = z_i[k][None] - gx.mu_i[:, None]
        rows.append(_log_density_core(s_, dr_, di_, zr, zi, eps))
    log_prob = torch.stack(rows)              # (B_z, B_x, S, T)
    log_q_z = torch.logsumexp(log_prob, dim=1) - math.log(gx.mu_r.shape[0])
    mi = (log_q_zx - log_q_z).mean(dim=1).mean(dim=0)
    return mi.mean()
