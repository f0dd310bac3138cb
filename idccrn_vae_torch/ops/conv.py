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

int8 serving mode (`quant`): `quantized_conv`, the JAX package's
`_quantized_conv`. The input gets one abs-max scale per sample, the
block kernel one per output channel; both round half to even and clip to
+-127. The products accumulate exactly in int32, as an im2col of the
quantized input times the quantized kernel (`torch._int_mm`, the same
code on the CPU and the card); the result is dequantized in float32 and
rounded to bf16. The transposed conv runs as JAX's does: a stride-1
conv of the lhs-dilated input with the flipped kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


# ---------------------------------------------------------------- int8

# bytes of one im2col chunk of the int8 path (the batch is split so
# that no chunk's patch matrix is larger)
IM2COL_BYTES = 1 << 28


def quantize_stage(quant: bool, quant_min_ch: int, cin: int,
                   cout: int) -> bool:
    """int8 applies where both channel counts of the weights this call
    receives reach quant_min_ch; other stages keep bf16."""
    return quant and min(cin, cout) >= quant_min_ch


def _over_127(t: torch.Tensor) -> torch.Tensor:
    """t / 127, correctly rounded on every device. CUDA turns division by
    a Python number into a product with its rounded reciprocal, which is
    one float32 step off for some t; a scale one step off moves the
    quotients that sit at a rounding tie (common on bf16 maps, whose
    values are often the abs-max times a short fraction) to the other
    int8 step. A tensor divisor keeps IEEE division."""
    return t / torch.full((), 127.0, device=t.device)


def quantize_input(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cpack (B, F, T, C) -> (int8 map, (B, 1, 1, 1) float32 scale): the
    abs-max over (F, T, C) of each sample / 127, floored at 1e-12. Per
    sample, so one utterance's output does not depend on its batchmates'
    levels."""
    xf = x.float()
    sx = _over_127(torch.clamp(xf.abs().amax(dim=(1, 2, 3), keepdim=True),
                               min=1e-12))
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def quantize_kernel(kernel: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A forward kernel (Cout, Cin, kh, kw) -> (int8 kernel, float32
    scale per output channel, (Cout,)). The transposed conv's block
    kernel (2Cin, 2Cout, kh, kw) has its output channels on dim 1; its
    forward kernel (`int8_conv_geometry`) is a permutation of it, so the
    scales are the same."""
    kf = kernel.float()
    sw = _over_127(torch.clamp(kf.abs().amax(dim=(1, 2, 3)), min=1e-12))
    kq = torch.round(kf / sw[:, None, None, None])
    return torch.clamp(kq, -127, 127).to(torch.int8), sw


def int8_conv_acc(xq: torch.Tensor, kq: torch.Tensor,
                  stride: Sequence[int],
                  pad: Sequence[Tuple[int, int]],
                  lhs_dilation: Sequence[int] = (1, 1)) -> torch.Tensor:
    """The exact int32 accumulator of a conv of int8 operands.

    xq: cpack (B, F, T, Cin) int8; kq: (Cout, Cin, kh, kw) int8 (OIHW);
    pad: ((f_lo, f_hi), (t_lo, t_hi)), applied after the lhs dilation.
    Returns (B, F', T', Cout) int32.

    An im2col of the input, (B*F'*T', kh*kw*Cin), times the kernel as
    (kh*kw*Cin, Cout) through `torch._int_mm`, the batch split so that
    one patch matrix stays under IM2COL_BYTES. On CUDA `_int_mm` wants
    more than 16 rows and K, N multiples of 8: K and N are zero-padded
    (exact), and the rows of every chunk are at least 17.
    """
    b, f, t, cin = xq.shape
    cout, _, kh, kw = kq.shape
    df, dt = lhs_dilation
    if (df, dt) != (1, 1):
        dil = xq.new_zeros((b, (f - 1) * df + 1, (t - 1) * dt + 1, cin))
        dil[:, ::df, ::dt] = xq
        xq = dil
    (f_lo, f_hi), (t_lo, t_hi) = pad
    xq = F.pad(xq, (0, 0, t_lo, t_hi, f_lo, f_hi))
    sf, st = stride
    fo = (xq.shape[1] - kh) // sf + 1
    to = (xq.shape[2] - kw) // st + 1
    k = kh * kw * cin
    kp, npad = -k % 8, -cout % 8  # zero rows and columns up to 8s
    # (kh, kw, Cin, Cout) -> (K, Cout), as the transposed view of a
    # contiguous (Cout, K): the column-major right operand cuBLASLt's
    # int8 product takes
    w = kq.permute(0, 2, 3, 1).reshape(cout, k)
    w = F.pad(w, (0, kp, 0, npad)).contiguous().t()
    rows = fo * to
    per = max(1, IM2COL_BYTES // max(1, rows * (k + kp)))
    out = torch.empty((b, fo, to, cout), dtype=torch.int32,
                      device=xq.device)
    for s in range(0, b, per):
        xs = xq[s : s + per]
        taps = [xs[:, i : i + sf * (fo - 1) + 1 : sf,
                   j : j + st * (to - 1) + 1 : st]
                for i in range(kh) for j in range(kw)]
        cols = torch.stack(taps, dim=3).reshape(-1, k)  # (b*fo*to, K)
        m = cols.shape[0]
        cols = F.pad(cols, (0, kp, 0, max(0, 17 - m)))
        acc = torch._int_mm(cols, w)[:m, :cout]
        out[s : s + per] = acc.reshape(xs.shape[0], fo, to, cout)
    return out


def quantized_conv(x: torch.Tensor, kernel: torch.Tensor,
                   stride: Sequence[int],
                   pad: Sequence[Tuple[int, int]],
                   lhs_dilation: Sequence[int] = (1, 1)) -> torch.Tensor:
    """int8 conv with dynamic symmetric quantization, serving only.

    x: cpack (B, F, T, Cin) in any float dtype; kernel: (Cout, Cin, kh,
    kw) float, the forward kernel. Returns the dequantized output,
    (y * sx * sw) in float32 rounded to bf16, as JAX's `_quantized_conv`.
    """
    xq, sx = quantize_input(x)
    kq, sw = quantize_kernel(kernel)
    y = int8_conv_acc(xq, kq, stride, pad, lhs_dilation)
    return (y.float() * (sx * sw)).to(torch.bfloat16)


def int8_conv_geometry(wr, wi, stride: Sequence[int],
                       padding: Sequence[int], causal: bool,
                       transposed: bool):
    """(forward kernel (Cout, Cin, kh, kw) float, stride, pad,
    lhs_dilation) of a complex conv or transposed conv on the int8 path.
    The transposed conv's forward kernel is its block kernel flipped in
    space, (in, out) -> (out, in), with padding (k - 1 - p) per side on
    the lhs-dilated input; the causal one drops the last time column."""
    kh, kw = wr.shape[2:]
    pf, pt = padding
    kernel = block_kernel(wr, wi, transposed)
    if not transposed:
        return (kernel, tuple(stride),
                ((pf, pf), (pt, pt - 1) if causal else (pt, pt)), (1, 1))
    t_hi = kw - 1 - pt - (1 if causal else 0)
    return (kernel.flip(2, 3).transpose(0, 1), (1, 1),
            ((kh - 1 - pf, kh - 1 - pf), (kw - 1 - pt, t_hi)), tuple(stride))


def _quantized(x, wr, wi, br, bi, stride, padding, causal, transposed):
    kernel, st, pad, dil = int8_conv_geometry(wr, wi, stride, padding,
                                              causal, transposed)
    return _add_bias(quantized_conv(x, kernel, st, pad, dil), br, bi)


# ------------------------------------------------------------ float convs


def complex_conv2d(x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor,
                   br: torch.Tensor, bi: torch.Tensor,
                   stride: Sequence[int], padding: Sequence[int],
                   causal: bool = False,
                   compute_dtype: Optional[torch.dtype] = None,
                   quant: bool = False,
                   quant_min_ch: int = 16) -> torch.Tensor:
    """Complex conv over cpack maps (B, F, T, 2Cin) -> (B, F', T', 2Cout).

    stride/padding are (freq, time) as in the reference net config.
    causal: the reference pads time (pt, pt) and drops the last output
    column; with time stride 1 that equals padding (pt, pt - 1), applied
    here with F.pad because torch convs pad symmetrically only.
    quant: the int8 path (`quantized_conv`) where both channel counts
    reach quant_min_ch.
    """
    if quantize_stage(quant, quant_min_ch, wr.shape[1], wr.shape[0]):
        return _quantized(x, wr, wi, br, bi, stride, padding, causal, False)
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
                             compute_dtype: Optional[torch.dtype] = None,
                             quant: bool = False,
                             quant_min_ch: int = 16) -> torch.Tensor:
    """Complex transposed conv (torch ConvTranspose2d semantics) on cpack maps.

    wr/wi are (Cin, Cout, kh, kw); br/bi may be None (no bias, used for
    the decoder's skip half). causal drops the last output time column
    (the reference's causal_ComplexConvTranspose2d). quant: the int8
    path where both channel counts of wr reach quant_min_ch.
    """
    if quantize_stage(quant, quant_min_ch, wr.shape[0], wr.shape[1]):
        return _quantized(x, wr, wi, br, bi, stride, padding, causal, True)
    xin, kernel = _operands(x, wr, wi, True, compute_dtype)
    y = F.conv_transpose2d(xin, kernel, stride=tuple(stride),
                           padding=tuple(padding))
    y = _cpack(y)
    return _add_bias(y[:, :, :-1] if causal else y, br, bi)
