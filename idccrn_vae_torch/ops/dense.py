"""ComplexDense: independent real/imag linear layers.

The reference's ComplexDense is not a true complex linear: real and
imag each get their own nn.Linear with no cross terms. Mirrors
`idccrn_vae_tpu/ops/dense.py`, whose output is float32 whatever the
compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from idccrn_vae_torch.ops.complex import csplit


def rounded(t: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """t rounded to dtype and held in float32.

    The JAX package multiplies reduced-precision operands with float32
    accumulation and a float32 result (preferred_element_type). A bf16
    torch.matmul rounds its result to bf16, so the port multiplies in
    float32 on operands rounded to the compute dtype instead: the
    products are exact and the rounding points are the JAX ones.
    """
    if dtype is None or dtype == torch.float32:
        return t.float()
    return t.to(dtype).float()


def complex_dense(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                  br: torch.Tensor, bi: torch.Tensor,
                  compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(..., 2*In) cpack -> (..., 2*Out) float32 cpack.

    wr/wi are torch Linear weights (Out, In); br/bi (Out,).
    """
    re, im = csplit(x)
    out_re = F.linear(rounded(re, compute_dtype), rounded(wr, compute_dtype),
                      br.float())
    out_im = F.linear(rounded(im, compute_dtype), rounded(wi, compute_dtype),
                      bi.float())
    return torch.cat([out_re, out_im], dim=-1)
