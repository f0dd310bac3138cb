"""The decoder's transposed convs stage by stage on one card, in three
formulations, with analytic MACs and shares of the card's peak: the
port's counterpart of tools/profile_decoder.py.

Serving shapes (tools/bench.py): B=32, T=481 frames, bf16, the stage plan
of the reference geometry from the port's config (`decoder_plan`, skip
channels included; frequency 5 -> 9 -> ... -> 257). Per stage, with one
random block kernel:
  A. current: `ops/conv.complex_conv_transpose2d` as it runs (cuDNN, a
     channels_last view of the cpack map, the block kernel built per
     call);
  B. the other memory format: the same transposed conv on contiguous
     NCHW operands;
  C. sub-pixel: one stride-1 conv emitting both frequency phases as
     extra output channels, interleaved after (written as the JAX tool
     writes it, :81-110), held against A at f32 (TF32 off) to 1e-3
     before it is timed.
Each is timed over ITERS launches after 2 warm ones, the window closed
by a scalar fetch; eager launches are not elided, so no feedback chain
is needed. MACs as the JAX tool counts them (:146-147): dense counts the
lhs-dilation's zero taps, B x F_out x T x 2Cin x 2Cout x 5 x 2; useful is
half of it. mfu_current_useful divides 2 x useful MACs per second of A by
the dense BF16 peak (tools/common.py). The JAX tool's mfu_current_dense
(the dense count over the peak) was a utilization on the TPU, whose
lowering computes the zero taps; cuDNN's transposed conv skips them, so
here the same ratio is no share of the card (it passes 1 on the wide
stages) and is reported as `dense_rate_over_peak`.

  python -m idccrn_vae_torch.tools.profile_decoder [--iters 50]
      [--tiny --device cpu]

writes PROFILE_DECODER_TORCH.json (or --out) with the card record.
"""

from __future__ import annotations

import argparse
import json
import os

import torch
import torch.nn.functional as F

from idccrn_vae_torch.models.config import (
    DccrnConfig,
    decoder_plan,
    freq_sizes,
)
from idccrn_vae_torch.ops.conv import block_kernel, complex_conv_transpose2d
from idccrn_vae_torch.tools import common

B, T = 32, 481
ITERS = 50
SUBPIXEL_TOL = 1e-3
STRIDE, KERNEL = (2, 1), (5, 2)


def stage_shapes(cfg: DccrnConfig):
    """[(stage, cin, cout, f_in, f_out)] of the decoder (the JAX tool's
    plan and frequency ladder)."""
    fs = [freq_sizes(cfg)[-1]] + list(reversed(freq_sizes(cfg)[:-1])) \
        + [cfg.stft.freq_bins]
    return [(i, cin, cout, fs[i], fs[i + 1])
            for i, (cin, cout) in enumerate(decoder_plan(cfg))]


def macs(b: int, f_out: int, t: int, cin: int, cout: int) -> tuple:
    """(dense, useful) MACs of one stage (tools/profile_decoder.py:146)."""
    dense = b * f_out * t * (2 * cin) * (2 * cout) * KERNEL[0] * KERNEL[1]
    return dense, dense / 2


def current(x, wr, wi, cfg: DccrnConfig, cdt):
    """A: the port's transposed conv as the decoder calls it (no bias, as
    the skip half)."""
    return complex_conv_transpose2d(x, wr, wi, None, None, STRIDE,
                                    (cfg.freq_pad, 0), causal=True,
                                    compute_dtype=cdt)


def nchw(x, wr, wi, cfg: DccrnConfig, cdt):
    """B: contiguous NCHW operands instead of the channels_last view."""
    kernel = block_kernel(wr, wi, True).to(cdt).contiguous()
    xin = x.to(cdt).permute(0, 3, 1, 2).contiguous()
    y = F.conv_transpose2d(xin, kernel, stride=STRIDE,
                           padding=(cfg.freq_pad, 0))
    return y[..., :-1].permute(0, 2, 3, 1)


def subpixel_kernel(wr, wi, cdt):
    """The transposed conv's block kernel (2Cin, 2Cout, 5, kw) -> the
    sub-pixel kernel (2 x 2Cout, 2Cin, 3, kw): the equivalent forward
    kernel K (flipped, in and out swapped) split by output row phase.
    Output row 2r sums K[0] x[r-1] + K[2] x[r] + K[4] x[r+1], row 2r+1
    K[1] x[r] + K[3] x[r+1]."""
    k = block_kernel(wr, wi, True).flip(2, 3).transpose(0, 1)
    ph0 = torch.stack([k[:, :, 0], k[:, :, 2], k[:, :, 4]], dim=2)
    ph1 = torch.stack([torch.zeros_like(k[:, :, 0]), k[:, :, 1],
                       k[:, :, 3]], dim=2)
    return torch.cat([ph0, ph1], dim=0).to(cdt)


def subpixel(x, k_sub, f_out: int, cdt):
    """C: one stride-1 conv (frequency pad 1, causal time pad 1) and the
    phase interleave; cpack in and out."""
    xin = F.pad(x.to(cdt).permute(0, 3, 1, 2), (1, 0))
    y = F.conv2d(xin, k_sub, padding=(1, 0))
    b, c2, f, t = y.shape
    y = y.reshape(b, 2, c2 // 2, f, t).permute(0, 2, 3, 1, 4)
    return y.reshape(b, c2 // 2, 2 * f, t)[:, :, :f_out].permute(0, 2, 3, 1)


def subpixel_error(x, wr, wi, cfg, f_out: int) -> float:
    """max |C - A| at f32, TF32 off."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x32 = x.float()
        ref = current(x32, wr, wi, cfg, torch.float32)
        sub = subpixel(x32, subpixel_kernel(wr, wi, torch.float32), f_out,
                       torch.float32)
        return float((ref - sub).abs().max())
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def stage_weights(cin: int, cout: int, gen: torch.Generator):
    """torch ConvTranspose2d-style uniform init (fan_in = cout x 5 x 2)."""
    bound = 1.0 / (cout * KERNEL[0] * KERNEL[1]) ** 0.5
    shape = (cin, cout, *KERNEL)
    return tuple(bound * (2 * torch.rand(shape, generator=gen) - 1)
                 for _ in range(2))


def profile_stage(stage, cin, cout, f_in, f_out, cfg, b, t, iters, device,
                  peak) -> dict:
    gen = torch.Generator().manual_seed(stage)
    wr, wi = (w.to(device) for w in stage_weights(cin, cout, gen))
    x = torch.randn(b, f_in, t, 2 * cin, generator=gen).to(device)
    err = subpixel_error(x, wr, wi, cfg, f_out)
    if not err < SUBPIXEL_TOL:
        raise AssertionError(f"stage {stage}: sub-pixel differs by {err}")
    cdt = torch.bfloat16
    xb = x.to(cdt)
    k_sub = subpixel_kernel(wr, wi, cdt)
    t_cur = common.time_calls(lambda: current(xb, wr, wi, cfg, cdt), iters,
                              device)
    t_nchw = common.time_calls(lambda: nchw(xb, wr, wi, cfg, cdt), iters,
                               device)
    t_sub = common.time_calls(lambda: subpixel(xb, k_sub, f_out, cdt), iters,
                              device)
    dense, useful = macs(b, f_out, t, cin, cout)
    return {"stage": stage, "cin": cin, "cout": cout, "f_in": f_in,
            "f_out": f_out, "ms_current": 1e3 * t_cur,
            "ms_nchw": 1e3 * t_nchw, "ms_subpixel": 1e3 * t_sub,
            "subpixel_max_abs_err_f32": err,
            "dense_macs": dense, "useful_macs": useful,
            "gflop_dense": 2 * dense / 1e9,
            "dense_rate_over_peak": 2 * dense / t_cur / (peak * 1e12),
            "mfu_current_useful": 2 * useful / t_cur / (peak * 1e12)}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_args(p, "PROFILE_DECODER_TORCH.json")
    p.add_argument("--iters", type=int, default=None,
                   help=f"timed launches per formulation (default {ITERS})")
    args = p.parse_args(argv)
    device = common.device_of(args)
    cfg = DccrnConfig(causal=True, **common.geometry(args.tiny))
    b, t = (2, 50) if args.tiny else (B, T)
    iters = args.iters or (2 if args.tiny else ITERS)
    peak = common.PEAK_TFLOPS["bf16"]
    report = {"tool": "idccrn_vae_torch.tools.profile_decoder",
              "counterpart": "tools/profile_decoder.py",
              "card": common.card_record(device),
              "B": b, "T": t, "iters": iters, "compute": "bf16",
              "tiny": args.tiny, "peak_bf16_tflops": peak,
              "peak_source": common.PEAK_SOURCE,
              "formulations": {
                  "current": "ops/conv.complex_conv_transpose2d (cuDNN "
                             "conv_transpose2d, channels_last operands, "
                             "block kernel built per call)",
                  "nchw": "the same on contiguous NCHW operands",
                  "subpixel": "stride-1 conv over both phases + "
                              "interleave, kernel built once"},
              "results": []}
    for shape in stage_shapes(cfg):
        rec = profile_stage(*shape, cfg, b, t, iters, device, peak)
        report["results"].append(rec)
        print(json.dumps(rec), flush=True)
    report["totals_ms"] = {k: sum(r[k] for r in report["results"])
                           for k in ("ms_current", "ms_nchw", "ms_subpixel")}
    common.write_report(args.out, report)
    print("totals:", json.dumps(report["totals_ms"]))
    print(f"wrote {os.path.abspath(args.out)}")
    return report


if __name__ == "__main__":
    main()
