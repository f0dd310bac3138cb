"""Complex batch normalization (Trabelsi-style 2x2 whitening), eval path.

Mirrors `idccrn_vae_tpu/ops/batchnorm.py` with running statistics: the
closed-form inverse square root of the per-channel 2x2 covariance
(``s = sqrt(det)``, ``t = sqrt(tau + 2 s)``, det clamped at 1e-8,
epsilon 1e-5), the learnable gamma_rr/gamma_ri/gamma_ii and
beta_r/beta_i. The statistics math runs in float32 whatever the
activation dtype; the output is cast back to it.

The whitening is a per-channel complex affine map, so its coefficients
are folded once into a (2, 2, C) matrix and a (2, C) offset, and the
pass over the activation is two fused multiply-adds in float32.
Train-mode statistics belong to the training slice.
"""

from __future__ import annotations

from typing import Dict

import torch

_EPS = 1e-5


def whiten_coefficients(params: Dict[str, torch.Tensor],
                        stats: Dict[str, torch.Tensor]):
    """-> (m (2, 2, C), c0 (2, C)) with out_j = sum_k m[k, j] x_k + c0[j].

    k and j index (real, imag) of the input and output.
    """
    f32 = lambda t: t.reshape(-1).float()
    vrr, vri, vii = f32(stats["Vrr"]), f32(stats["Vri"]), f32(stats["Vii"])
    tau = vrr + vii
    det = torch.clamp(vrr * vii - vri * vri + _EPS, min=1e-8)
    s = torch.sqrt(det)
    t = torch.sqrt(tau + 2.0 * s + _EPS)
    inv_st = 1.0 / (s * t + _EPS)
    wrr = (vii + s) * inv_st
    wii = (vrr + s) * inv_st
    wri = -vri * inv_st

    g_rr, g_ri, g_ii = (f32(params["gamma_rr"]), f32(params["gamma_ri"]),
                        f32(params["gamma_ii"]))
    zrr = g_rr * wrr + g_ri * wri
    zri = g_rr * wri + g_ri * wii
    zir = g_ri * wrr + g_ii * wri
    zii = g_ri * wri + g_ii * wii

    mr, mi = f32(stats["mean_r"]), f32(stats["mean_i"])
    c_re = f32(params["beta_r"]) - zrr * mr - zri * mi
    c_im = f32(params["beta_i"]) - zir * mr - zii * mi
    m = torch.stack([torch.stack([zrr, zir]), torch.stack([zri, zii])])
    return m, torch.stack([c_re, c_im])


def complex_batch_norm(x: torch.Tensor, params: Dict[str, torch.Tensor],
                       stats: Dict[str, torch.Tensor],
                       train: bool = False) -> torch.Tensor:
    """Apply eval-mode complex BN to a cpack map (B, F, T, 2C).

    params: gamma_rr, gamma_ri, gamma_ii, beta_r, beta_i, each (C,).
    stats: mean_r, mean_i, Vrr, Vri, Vii, each (C,) or (1, C, 1, 1).
    Returns the normalized map in x's dtype.
    """
    if train:
        raise NotImplementedError(
            "train-mode complex batch norm is not ported yet (ROADMAP "
            "queue 1 item 14); call it with train=False")
    c = x.shape[-1] // 2
    m, c0 = whiten_coefficients(params, stats)
    xv = x.unflatten(-1, (2, c))  # (..., 2, C): [re; im]
    # addcmul promotes bf16 activations to float32 without a copy
    out = torch.addcmul(c0, xv[..., 0:1, :], m[0])
    out = out.addcmul_(xv[..., 1:2, :], m[1])
    return out.flatten(-2).to(x.dtype)
