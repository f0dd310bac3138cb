"""The plain reference of a CVAE pretraining step: the train-mode forward
of `model.py` (batch-statistics BN, the decoder's skip channels padded
with zeros), the CVAE loss and Adam with L2 weight decay, float32.

Loss (the upstream `complex_standard_vae_loss` with the 'multiple'
reconstruction): w0 * complex MSE + w1 * magnitude MSE + w2 * negative
SI-SNR, each spectral term summed over frequency and averaged over
(rows, frames); plus kl_weight times the closed-form KL of the posterior
against the standard complex Gaussian, summed over the latent, less
zdim, averaged over (batch, frames). The target is the clean segment
and its spectrum, repeated over the S samples.

Adam (torch.optim.Adam's update): g <- g + wd * p, m and v with betas
(0.9, 0.999), p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t)
+ 1e-8).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from benchmark.reference.model import (
    F32,
    Geometry,
    Precision,
    complex_lstm,
    decode,
    encode,
    flatten,
    heads,
    istft,
    project_delta,
    sample,
    stft,
)

KL_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Recipe:
    num_samples: int
    kl_weight: float
    recon_weights: Tuple[float, float, float]
    lr: float
    weight_decay: float
    betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8


def si_snr_loss(src: torch.Tensor, est: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    proj = ((src * est).sum(-1, keepdim=True)
            / ((src * src).sum(-1, keepdim=True) + eps)) * src
    noise = est - proj
    ratio = (proj * proj).sum(-1) / ((noise * noise).sum(-1) + eps)
    return -(10.0 * torch.log10(ratio + eps)).mean()


def kl_standard(g) -> torch.Tensor:
    """KL(q || N(0, I)) of complex Gaussians per (batch, frame)."""
    zdim = g.mu_r.shape[-1]
    s1 = torch.exp(g.log_sigma)
    dr, di = project_delta(s1, g.delta_r, g.delta_i, KL_EPS, 0.99)
    d1 = dr * dr + di * di
    log_det_q = torch.log(0.25 * (s1 * s1 - d1) + KL_EPS)
    log_det_p = torch.log(torch.tensor(0.25 + KL_EPS, device=s1.device))
    coeff = 2.0 / (1.0 + KL_EPS)
    quad = g.mu_r * g.mu_r + g.mu_i * g.mu_i
    return (0.5 * (coeff * (s1 + quad) + log_det_p - log_det_q)).sum(-1) - zdim


def is_buffer(name: str) -> bool:
    """BN running statistics: state that no optimizer moves."""
    return any(b in name for b in ("running_mean", "Vrr", "Vri", "Vii"))


def cvae_loss(wav: torch.Tensor, enc: dict, dec: dict, draws,
              geo: Geometry, recipe: Recipe,
              p: Precision = F32) -> Tuple[torch.Tensor, dict]:
    """The step's total loss on clean segments wav (B, L), and its terms
    (cpx, mag, kl); draws (eps_r, eps_i), each (B, S, T, zdim)."""
    s = recipe.num_samples
    y = stft(wav, geo)
    bott, _ = encode(y, enc, geo, p, train=True)
    re, im, _ = complex_lstm(*flatten(bott), enc, geo, p)
    post = heads(re, im, geo.zdim, 1)[0]
    pr, pi = decode(sample(post, *draws), None, dec, geo, p, train=True)
    recon = istft(pr, pi, geo)
    tr = y[0][:, 0].repeat_interleave(s, 0)
    ti = y[1][:, 0].repeat_interleave(s, 0)
    cpx = ((pr - tr) ** 2 + (pi - ti) ** 2).sum(1).mean()
    mag = ((torch.sqrt(pr * pr + pi * pi + 1e-6)
            - torch.sqrt(tr * tr + ti * ti + 1e-6)) ** 2).sum(1).mean()
    src = wav.repeat_interleave(s, 0)[:, : recon.shape[1]]
    w = recipe.recon_weights
    total = w[0] * cpx + w[1] * mag + w[2] * si_snr_loss(src, recon)
    kl = kl_standard(post).mean()
    return total + recipe.kl_weight * kl, {"cpx": cpx, "mag": mag, "kl": kl}


def follow(enc_w: dict, dec_w: dict, batches: Sequence[torch.Tensor],
           draws: Sequence, geo: Geometry, recipe: Recipe,
           p: Precision = F32) -> dict:
    """Adam steps from the weights (enc_w, dec_w), one per batch.

    Returns {"loss": [per step], "terms": [per step {cpx, mag, kl}],
    "grad1_loss": {name: the first step's
    gradient of the loss}, "grad1": {name: the same as Adam takes it,
    the L2 term added}, "params": {name: after the last step}}, names
    "enc.<key>" / "dec.<key>", parameters only."""
    sides = {"enc": enc_w, "dec": dec_w}
    params = {f"{side}.{k}": v.detach().float().clone()
              for side, sd in sides.items() for k, v in sd.items()
              if not is_buffer(k)}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2 = recipe.betas
    out = {"loss": []}
    for step, (wav, draw) in enumerate(zip(batches, draws), start=1):
        leaves = {k: t.requires_grad_(True) for k, t in params.items()}
        model = {side: {k: (leaves[f"{side}.{k}"] if f"{side}.{k}" in leaves
                            else v) for k, v in sd.items()}
                 for side, sd in sides.items()}
        loss, terms = cvae_loss(wav, model["enc"], model["dec"], draw, geo,
                                recipe, p)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out["loss"].append(float(loss.detach()))
        out.setdefault("terms", []).append(
            {k: float(v.detach()) for k, v in terms.items()})
        del loss, model
        with torch.no_grad():
            params = {}
            for (k, t), g in zip(leaves.items(), grads):
                t = t.detach()
                if step == 1:
                    out.setdefault("grad1_loss", {})[k] = g.clone()
                g = g + recipe.weight_decay * t
                if step == 1:
                    out.setdefault("grad1", {})[k] = g.clone()
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** step) ** 0.5).add_(
                    recipe.adam_eps)
                params[k] = t.addcdiv(m[k], denom,
                                      value=-recipe.lr / (1 - b1 ** step))
        del grads, leaves
    out["params"] = params
    return out
