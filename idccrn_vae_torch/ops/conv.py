"""Complex 2-D convolutions as single block-matrix real convolutions.

Mirrors `idccrn_vae_tpu/ops/conv.py`: the complex product
``re = x_re*Wr - x_im*Wi``, ``im = x_re*Wi + x_im*Wr`` runs as ONE real
cuDNN convolution over a block kernel, with the effective bias
(br - bi, br + bi) (the reference applies each conv's own bias in all 4
passes).

Layout: feature maps are cpack (B, F, T, 2C), real channels then imag,
as in the JAX package. A contiguous cpack map permuted to (B, 2C, F, T)
is a channels_last NCHW view, which cuDNN consumes without a copy; its
output is channels_last too and permutes back to cpack for free.

Weights use torch's layouts: conv (Cout, Cin, kh, kw), transposed conv
(Cin, Cout, kh, kw). The block kernel is therefore laid out
(out, in) = [[Wr, -Wi], [Wi, Wr]] for the conv and
(in, out) = [[Wr, Wi], [-Wi, Wr]] for the transposed conv.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """cpack (B, F, T, 2C) -> (B, 2C, F, T) view (channels_last)."""
    return x.permute(0, 3, 1, 2)


def _cpack(y: torch.Tensor) -> torch.Tensor:
    """(B, 2C, F, T) -> cpack (B, F, T, 2C) view."""
    return y.permute(0, 2, 3, 1)


def block_kernel(wr: torch.Tensor, wi: torch.Tensor,
                 transposed: bool = False) -> torch.Tensor:
    """Assemble the real block kernel of a complex conv.

    conv: wr/wi (Cout, Cin, kh, kw) -> (2Cout, 2Cin, kh, kw).
    transposed: wr/wi (Cin, Cout, kh, kw) -> (2Cin, 2Cout, kh, kw).
    """
    if transposed:  # rows are inputs: [x_re; x_im] -> [out_re | out_im]
        top = torch.cat([wr, wi], dim=1)
        bot = torch.cat([-wi, wr], dim=1)
    else:           # rows are outputs
        top = torch.cat([wr, -wi], dim=1)
        bot = torch.cat([wi, wr], dim=1)
    return torch.cat([top, bot], dim=0)


def _operands(x, wr, wi, transposed, compute_dtype):
    dtype = x.dtype if compute_dtype is None else compute_dtype
    kernel = block_kernel(wr, wi, transposed).to(dtype)
    kernel = kernel.contiguous(memory_format=torch.channels_last)
    return _nchw(x.to(dtype).contiguous()), kernel


def _add_bias(y: torch.Tensor, br, bi) -> torch.Tensor:
    """Bias added to the conv output rounded to its dtype, as the JAX
    package does (``out + bias.astype(out.dtype)``). Inside the cuDNN
    call the sum would be rounded once instead of twice, which in bf16
    changes a third of the first stage's outputs by one rounding."""
    if br is None:
        return y
    return y + torch.cat([br - bi, br + bi]).to(y.dtype)


def complex_conv2d(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                   br: torch.Tensor, bi: torch.Tensor,
                   stride: Sequence[int], padding: Sequence[int],
                   causal: bool = False,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Complex conv over cpack maps (B, F, T, 2Cin) -> (B, F', T', 2Cout).

    stride/padding are (freq, time) as in the reference net config.
    causal: the reference pads time (pt, pt) and drops the last output
    column; with time stride 1 that equals padding (pt, pt - 1), applied
    here with F.pad because torch convs pad symmetrically only.
    """
    pf, pt = padding
    if causal:
        x = F.pad(x, (0, 0, pt, pt - 1))
        pad = (pf, 0)
    else:
        pad = (pf, pt)
    xin, kernel = _operands(x, wr, wi, False, compute_dtype)
    y = F.conv2d(xin, kernel, stride=tuple(stride), padding=pad)
    return _add_bias(_cpack(y), br, bi)


def complex_conv_transpose2d(x: torch.Tensor, wr: torch.Tensor,
                             wi: torch.Tensor, br: Optional[torch.Tensor],
                             bi: Optional[torch.Tensor],
                             stride: Sequence[int], padding: Sequence[int],
                             causal: bool = False,
                             compute_dtype: Optional[torch.dtype] = None
                             ) -> torch.Tensor:
    """Complex transposed conv (torch ConvTranspose2d semantics) on cpack maps.

    wr/wi are (Cin, Cout, kh, kw); br/bi may be None (no bias, used for
    the decoder's skip half). causal drops the last output time column
    (the reference's causal_ComplexConvTranspose2d).
    """
    xin, kernel = _operands(x, wr, wi, True, compute_dtype)
    y = F.conv_transpose2d(xin, kernel, stride=tuple(stride),
                           padding=tuple(padding))
    y = _cpack(y)
    return _add_bias(y[:, :, :-1] if causal else y, br, bi)
