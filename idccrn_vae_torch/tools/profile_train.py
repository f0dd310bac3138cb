"""The CVAE pretraining step split into its programs on one card, with
counted FLOPs and shares of the card's peak: the port's counterpart of
tools/profile_train.py.

The step of the production sweet spot: B=16, bf16, num_samples 5, 3 s
segments at the reference geometry. Three nested programs: the forward
(the training forward and the loss, BN in train mode, no autograd), the
forward + backward (autograd through it), and the full step
(`PretrainTrainer.train_step`: both Adam updates on top); then the
encoder and decoder alone (`*_fwd_ms`, `*_fwdbwd_ms`) and the loss alone.
Each is timed over `--steps` calls after 2 warm ones, the window opened
after a synchronize and closed by a scalar fetch.

FLOPs: counted once per program with `torch.utils.flop_counter.
FlopCounterMode`, the counterpart of XLA's `cost_analysis` (:76-86). It
counts matrix products and convolutions (mm, bmm, addmm, convolution and
their backwards), not the elementwise passes (BN, PReLU, the LSTM's
gates, the STFT's FFTs, the optimizer), so `mfu` is a share of the
tensor-core peak of the compute dtype (tools/common.py) spent on the
counted work. The full step is held at the forward + backward count (the
optimizer adds no counted FLOPs). The decoder's counted forward
convolutions are cross-checked against `profile_decoder`'s analytic
useful MACs of the same stages at this step's rows (B x num_samples).

Not ported: the JAX tool's what-if probes (the LSTM scan's `unroll`,
buffer donation, :235-261) are XLA knobs with no eager counterpart.

  python -m idccrn_vae_torch.tools.profile_train [--steps 8]
      [--tiny --device cpu]

writes PROFILE_TRAIN_TORCH.json (or --out) with the card record.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.tools import common

B, NS, SECONDS, STEPS = 16, 5, 3.0, 8
KL_W = 0.01


def flops_of(fn) -> float:
    """FLOPs FlopCounterMode counts in one call of `fn`."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def conv_flops(fn) -> float:
    """Counted convolution FLOPs (forward and backward ops) of one call
    of `fn`."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(sum(v for op, v in counter.get_flop_counts()["Global"]
                     .items() if "convolution" in str(op)))


def sq(x) -> torch.Tensor:
    return x.float().pow(2).sum()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_args(p, "PROFILE_TRAIN_TORCH.json")
    p.add_argument("--steps", type=int, default=None,
                   help=f"timed calls per program (default {STEPS})")
    args = p.parse_args(argv)
    device = common.device_of(args)
    report = profile(device, args.tiny, args.steps)
    common.write_report(args.out, report)
    print(f"wrote {os.path.abspath(args.out)}")
    return report


def profile(device, tiny: bool = False, steps=None) -> dict:
    from idccrn_vae_torch.losses.vae_loss import (
        PretrainVaeLoss,
        kl_annealing_schedule,
    )
    from idccrn_vae_torch.tools.profile_decoder import macs, stage_shapes
    from idccrn_vae_torch.train.pretrain import PretrainTrainer, tile_samples

    geo = common.geometry(tiny)
    b, seconds = (2, 0.1) if tiny else (B, SECONDS)
    steps = steps or (1 if tiny else STEPS)
    n = int(seconds * common.FS)
    cfg = DccrnConfig(causal=True, num_samples=NS, compute="bf16", **geo)
    loss = PretrainVaeLoss(kl_annealing_schedule(20), 1.0, num_samples=NS)
    tr = PretrainTrainer(cfg, loss, 1e-3, device=device)
    wav = torch.from_numpy((0.1 * np.random.default_rng(0).standard_normal(
        (b, n))).astype(np.float32)).to(device)
    gen = torch.Generator(device).manual_seed(0)
    enc, dec = tr.encoder, tr.decoder
    enc.train()
    dec.train()
    params = list(enc.parameters()) + list(dec.parameters())

    def forward():
        with torch.no_grad():
            return tr._losses(wav, gen, KL_W)[0]

    def forward_backward():
        for q in params:
            q.grad = None
        total, _ = tr._losses(wav, gen, KL_W)
        total.backward()
        return params[0].grad

    def full_step():
        return tr.train_step(wav, gen, 0)["total"]

    peak, peak_name = common.peak_for("bf16")
    time_it = lambda fn: common.time_calls(fn, steps, device)
    t_fwd, t_fb = time_it(forward), time_it(forward_backward)
    t_step = time_it(full_step)
    f_fwd, f_fb = flops_of(forward), flops_of(forward_backward)

    def prog(t, f):
        return {"ms": 1e3 * t, "tflop": f / 1e12,
                "tflops_per_s": f / t / 1e12, "mfu": f / t / (peak * 1e12)}

    report = {"tool": "idccrn_vae_torch.tools.profile_train",
              "counterpart": "tools/profile_train.py",
              "card": common.card_record(device),
              "geometry": {**geo, "B": b, "num_samples": NS,
                           "T": n // cfg.stft.hop + 1, "compute": "bf16",
                           "fs": common.FS, "seconds": seconds,
                           "tiny": tiny},
              "peak_tflops": peak, "peak_name": peak_name,
              "peak_source": common.PEAK_SOURCE, "steps_timed": steps,
              "flop_counter": "torch.utils.flop_counter.FlopCounterMode: "
                              "mm/bmm/addmm/convolution and their "
                              "backwards; elementwise passes, FFTs and "
                              "the optimizer are not counted",
              "programs": {"forward": prog(t_fwd, f_fwd),
                           "forward_backward": prog(t_fb, f_fb),
                           "full_step": prog(t_step, f_fb)},
              "derived": {"backward_ms": 1e3 * (t_fb - t_fwd),
                          "optimizer_ms": 1e3 * (t_step - t_fb),
                          "bwd_over_fwd": (t_fb - t_fwd) / t_fwd,
                          "audio_s_per_s": b * seconds / t_step},
              "probes": "not ported: the JAX tool's scan unroll and buffer "
                        "donation probes are XLA knobs with no eager "
                        "counterpart"}
    print(json.dumps({k: report[k] for k in ("programs", "derived")},
                     indent=1), flush=True)

    # components: the activations are arguments of each program, drawn
    # once from a train-mode encoder pass
    with torch.no_grad():
        out = enc(wav, generator=gen)
    stft_x, z, skips = out.stft_x, out.z, [s.detach() for s in out.skips]

    def enc_fwd():
        with torch.no_grad():
            o = enc(wav, generator=gen)
            return sq(o.z) + sum(sq(s) for s in o.skips) + sq(o.gauss.mu_r)

    def enc_fwdbwd():
        for q in enc.parameters():
            q.grad = None
        o = enc(wav, generator=gen)
        (sq(o.z) + sum(sq(s) for s in o.skips) + sq(o.gauss.mu_r)).backward()
        return next(enc.parameters()).grad

    def dec_fwd():
        with torch.no_grad():
            recon, predict = dec(stft_x, z, skips)
            return sq(recon) + sq(predict)

    def dec_fwdbwd():
        for q in dec.parameters():
            q.grad = None
        recon, predict = dec(stft_x, z, skips)
        (sq(recon) + sq(predict)).backward()
        return next(dec.parameters()).grad

    with torch.no_grad():
        recon0, predict0 = dec(stft_x, z, skips)

    def loss_fwd():
        with torch.no_grad():
            wav_t = tile_samples(wav, NS)[:, : recon0.shape[1]]
            return tr.loss(wav_t, recon0, tile_samples(stft_x, NS), predict0,
                           out.gauss, z, KL_W).total

    comp = {}
    for key, fn in (("encoder_fwd_ms", enc_fwd),
                    ("encoder_fwdbwd_ms", enc_fwdbwd),
                    ("decoder_fwd_ms", dec_fwd),
                    ("decoder_fwdbwd_ms", dec_fwdbwd),
                    ("loss_fwd_ms", loss_fwd)):
        comp[key] = 1e3 * time_it(fn)
        comp[key.replace("_ms", "_tflop")] = flops_of(fn) / 1e12
        print(f"{key}: {comp[key]:.3f} ms", flush=True)
    report["components"] = comp

    # the decoder's own half of a stage runs on the B x num_samples rows,
    # the skip half once per batch row (the skips are shared over the
    # samples)
    t = z.shape[1]
    analytic = 0.0
    for i, cin, cout, _f, f_out in stage_shapes(cfg):
        main = cfg.decoder_channels[i]
        analytic += 2 * (macs(b * NS, f_out, t, main, cout)[1]
                         + macs(b, f_out, t, cin - main, cout)[1])
    counted = conv_flops(dec_fwd)
    report["decoder_conv_crosscheck"] = {
        "counted_forward_conv_tflop": counted / 1e12,
        "analytic_useful_tflop": analytic / 1e12,
        "counted_over_analytic": counted / analytic,
        "note": "FlopCounterMode counts a transposed conv over its input "
                "positions (the useful taps); the analytic count uses "
                "F_out = 2 F_in - 1 rows, so the ratio sits just above 1"}
    return report


if __name__ == "__main__":
    main()
