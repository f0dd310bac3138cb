"""Complex-tensor layout helpers.

Mirrors `idccrn_vae_tpu/ops/complex.py`. Complex feature maps are packed
channel-last, the cpack layout ``(..., 2*C)``: the first C channels real,
the last C imaginary. The reference's layout is a trailing axis of 2,
``(..., C, 2)`` with ``[..., 0]`` real and ``[..., 1]`` imaginary.

`creal`, `cimag` and `csplit` return views; `cpack`, `pair_to_cpack`,
`cpack_to_pair`, `cabs2` and `cabs` new tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch


def creal(x: torch.Tensor) -> torch.Tensor:
    """Real half of a cpack tensor (last dim 2*C)."""
    return x[..., : x.shape[-1] // 2]


def cimag(x: torch.Tensor) -> torch.Tensor:
    """Imaginary half of a cpack tensor."""
    return x[..., x.shape[-1] // 2:]


def csplit(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a cpack tensor into (real, imag)."""
    return creal(x), cimag(x)


def cpack(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Concatenate (real, imag) into cpack layout along the last dim."""
    return torch.cat([re, im], dim=-1)


def pair_to_cpack(x: torch.Tensor) -> torch.Tensor:
    """Reference layout ``(..., C, 2)`` -> cpack ``(..., 2*C)``."""
    return cpack(x[..., 0], x[..., 1])


def cpack_to_pair(x: torch.Tensor) -> torch.Tensor:
    """cpack ``(..., 2*C)`` -> reference layout ``(..., C, 2)``."""
    return torch.stack(csplit(x), dim=-1)


def cabs2(x: torch.Tensor) -> torch.Tensor:
    """Squared magnitude per complex channel, ``re^2 + im^2`` -> (..., C)."""
    re, im = csplit(x)
    return re * re + im * im


def cabs(x: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Magnitude per complex channel -> (..., C)."""
    return torch.sqrt(cabs2(x) + eps)
