"""Complex batch normalization (Trabelsi-style 2x2 whitening).

Mirrors `idccrn_vae_tpu/ops/batchnorm.py`: the closed-form inverse
square root of the per-channel 2x2 covariance (``s = sqrt(det)``,
``t = sqrt(tau + 2 s)``, det clamped at 1e-8, epsilon 1e-5), the
learnable gamma_rr/gamma_ri/gamma_ii and beta_r/beta_i. The statistics
math runs in float32 whatever the activation dtype; the output is cast
back to it.

Eval mode whitens with the running statistics. The whitening is then a
per-channel complex affine map, so its coefficients are folded once into
a (2, 2, C) matrix and a (2, C) offset, and the pass over the activation
is two fused multiply-adds in float32.

Train mode (`complex_batch_norm_train`) whitens with the batch mean and
2x2 covariance over (B, F, T), in the JAX order: the centred batch
first, then the affine of `_whiten_affine`; the output is differentiable
through the batch statistics. It also returns the new running statistics:
``0.9 * old + 0.1 * batch``, except that the first batch (``count == 0``)
replaces them wholesale, and with ``dis_mode`` every batch does.

In a data-parallel group (`parallel/distributed.py`) the batch
statistics span the global batch, as XLA's do under a mesh: the same two
passes, each a differentiable all-reduce of per-channel sums (the mean,
then the centred second moments), so every rank whitens with, and moves
its running statistics to, the same global statistics.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from idccrn_vae_torch.ops.complex import csplit
from idccrn_vae_torch.parallel import distributed

_EPS = 1e-5


def _inverse_sqrt(vrr, vii, vri):
    """(wrr, wii, wri): the inverse square root of [[Vrr, Vri], [Vri, Vii]]."""
    tau = vrr + vii
    det = torch.clamp(vrr * vii - vri * vri + _EPS, min=1e-8)
    s = torch.sqrt(det)
    t = torch.sqrt(tau + 2.0 * s + _EPS)
    inv_st = 1.0 / (s * t + _EPS)
    return (vii + s) * inv_st, (vrr + s) * inv_st, -vri * inv_st


def _gamma_product(params, wrr, wii, wri):
    """(zrr, zri, zir, zii): gamma times the whitening matrix."""
    f32 = lambda t: t.reshape(-1).float()
    g_rr, g_ri, g_ii = (f32(params["gamma_rr"]), f32(params["gamma_ri"]),
                        f32(params["gamma_ii"]))
    return (g_rr * wrr + g_ri * wri, g_rr * wri + g_ri * wii,
            g_ri * wrr + g_ii * wri, g_ri * wri + g_ii * wii)


def whiten_coefficients(params: Dict[str, torch.Tensor],
                        stats: Dict[str, torch.Tensor]):
    """-> (m (2, 2, C), c0 (2, C)) with out_j = sum_k m[k, j] x_k + c0[j].

    k and j index (real, imag) of the input and output.
    """
    f32 = lambda t: t.reshape(-1).float()
    zrr, zri, zir, zii = _gamma_product(
        params, *_inverse_sqrt(f32(stats["Vrr"]), f32(stats["Vii"]),
                               f32(stats["Vri"])))
    mr, mi = f32(stats["mean_r"]), f32(stats["mean_i"])
    c_re = f32(params["beta_r"]) - zrr * mr - zri * mi
    c_im = f32(params["beta_i"]) - zir * mr - zii * mi
    m = torch.stack([torch.stack([zrr, zir]), torch.stack([zri, zii])])
    return m, torch.stack([c_re, c_im])


def complex_batch_norm(x: torch.Tensor, params: Dict[str, torch.Tensor],
                       stats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Apply eval-mode complex BN to a cpack map (B, F, T, 2C).

    params: gamma_rr, gamma_ri, gamma_ii, beta_r, beta_i, each (C,).
    stats: mean_r, mean_i, Vrr, Vri, Vii, each (C,) or (1, C, 1, 1).
    Returns the normalized map in x's dtype.
    """
    c = x.shape[-1] // 2
    m, c0 = whiten_coefficients(params, stats)
    xv = x.unflatten(-1, (2, c))  # (..., 2, C): [re; im]
    # addcmul promotes bf16 activations to float32 without a copy
    out = torch.addcmul(c0, xv[..., 0:1, :], m[0])
    out = out.addcmul_(xv[..., 1:2, :], m[1])
    return out.flatten(-2).to(x.dtype)


def complex_batch_norm_train(x: torch.Tensor, params: Dict[str, torch.Tensor],
                             stats: Dict[str, torch.Tensor],
                             dis_mode: bool = False, momentum: float = 0.9
                             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Train-mode complex BN of a cpack map (B, F, T, 2C).

    stats: the running mean_r, mean_i, Vrr, Vri, Vii, each (C,) or
    (1, C, 1, 1), and `count` (a 0-dim integer tensor). Returns (the
    normalized map in x's dtype, the new statistics in the shapes given).
    The new statistics carry no autograd history. The copy rule is a
    `torch.where` on the device, so no step waits for the host.
    """
    re, im = (t.float() for t in csplit(x))
    axes = tuple(range(x.dim() - 1))  # (B, F, T): per channel
    mu_r, mu_i = distributed.batch_means([re, im], axes)
    re_c = re - mu_r
    im_c = im - mu_i
    vrr, vii, vri = distributed.batch_means([re_c * re_c, im_c * im_c, re_c * im_c],
                                 axes)
    vrr = vrr + _EPS
    vii = vii + _EPS

    zrr, zri, zir, zii = _gamma_product(params, *_inverse_sqrt(vrr, vii, vri))
    beta = lambda k: params[k].reshape(-1).float()
    out_re = zrr * re_c + zri * im_c + beta("beta_r")
    out_im = zir * re_c + zii * im_c + beta("beta_i")
    out = torch.cat([out_re, out_im], dim=-1).to(x.dtype)

    with torch.no_grad():
        count = stats["count"]
        copy = torch.ones_like(count, dtype=torch.bool) if dis_mode \
            else count == 0
        new = {"count": count + 1}
        for k, batch in (("mean_r", mu_r), ("mean_i", mu_i), ("Vrr", vrr),
                         ("Vri", vri), ("Vii", vii)):
            run = stats[k]
            batch = batch.reshape(run.shape)
            new[k] = torch.where(copy, batch,
                                 momentum * run + (1.0 - momentum) * batch)
    return out, new
