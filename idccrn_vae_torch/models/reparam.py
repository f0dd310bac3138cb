"""Complex-Gaussian latent parameterization + reparameterized sampling.

Mirrors `idccrn_vae_tpu/models/reparam.py`:

  z_r = mu_r + ((sigma+delta_r)/sqrt(2(sigma+delta_r))) * eps_r
  z_i = mu_i + (delta_i/sqrt(2(sigma+delta_r))) * eps_r
             + (sqrt(sigma^2-|delta|^2)/sqrt(2(sigma+delta_r))) * eps_i

with the |delta| <= 0.99*sigma projection and the reference's two
numerical guards: 'eps' (sliced-LSTM-head encoders: +epsilon inside
sqrts and denominators) and 'clamp' (fc-latent encoders: log_sigma
clamped to [-13, 13], sqrt arguments clamped to >= epsilon).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from idccrn_vae_torch.parallel.mesh import randn_rows

_EPS = 1e-6


class CGauss(NamedTuple):
    """Complex-Gaussian posterior parameters, each (B, T, H). Only the
    real part of the log_sigma head is used; its imaginary head output
    is kept in `log_sigma_i` so checkpoints round-trip."""

    mu_r: torch.Tensor
    mu_i: torch.Tensor
    log_sigma: torch.Tensor
    delta_r: torch.Tensor
    delta_i: torch.Tensor
    log_sigma_i: Optional[torch.Tensor] = None


def project_delta(sigma, delta_r, delta_i, eps: float = _EPS,
                  factor: float = 0.99):
    """Scale delta to |delta| <= factor*sigma where it violates the bound."""
    abs_delta = torch.sqrt(delta_r ** 2 + delta_i ** 2 + eps)
    scale = sigma * factor / (abs_delta + eps)
    viol = abs_delta >= (sigma - 1e-3)
    return (torch.where(viol, delta_r * scale, delta_r),
            torch.where(viol, delta_i * scale, delta_i))


def reparameterize(g: CGauss, num_samples: int, guard: str = "eps",
                   noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Draw num_samples per batch element; returns cpack (B*S, T, 2*H).

    Rows are sample-major within the batch (b0s0, b0s1, ..., b1s0, ...),
    the reference's view(B*num_samples, T, H).

    noise: optional explicit (eps_r, eps_i), each (B, S, T, H), so tests
    can drive this and the JAX function with identical draws. Without
    it the draws come from `generator` (on the tensors' device); in a
    data-parallel group they are the global batch's draws, this rank's
    rows kept (`parallel/mesh.randn_rows`).
    """
    if guard == "clamp":
        sigma = torch.exp(torch.clamp(g.log_sigma, -13.0, 13.0))
    else:
        sigma = torch.exp(g.log_sigma)
    delta_r, delta_i = project_delta(sigma, g.delta_r, g.delta_i)
    abs_delta2 = delta_r ** 2 + delta_i ** 2 + _EPS

    if guard == "clamp":
        denom = torch.sqrt(torch.clamp(2.0 * (sigma + delta_r), min=_EPS))
        scale_rr = (sigma + delta_r) / denom
        scale_ir = delta_i / denom
        scale_ii = torch.sqrt(torch.clamp(sigma ** 2 - abs_delta2,
                                          min=_EPS)) / denom
    else:
        denom = torch.sqrt(2.0 * (sigma + delta_r) + _EPS)
        scale_rr = (sigma + delta_r) / (denom + _EPS)
        scale_ir = delta_i / (denom + _EPS)
        scale_ii = torch.sqrt(sigma ** 2 - abs_delta2 + _EPS) / (denom + _EPS)

    b, t, h = g.mu_r.shape
    if noise is not None:
        eps_r, eps_i = (e.to(g.mu_r) for e in noise)
    else:
        shape = (b, num_samples, t, h)
        kw = dict(generator=generator, device=g.mu_r.device,
                  dtype=g.mu_r.dtype)
        eps_r = randn_rows(shape, **kw)
        eps_i = randn_rows(shape, **kw)

    z_r = g.mu_r[:, None] + scale_rr[:, None] * eps_r
    z_i = (g.mu_i[:, None] + scale_ir[:, None] * eps_r
           + scale_ii[:, None] * eps_i)
    z_r = z_r.reshape(b * num_samples, t, h)
    z_i = z_i.reshape(b * num_samples, t, h)
    return torch.cat([z_r, z_i], dim=-1)
