"""Train-step time of the five trainers at the reference geometry on one
card: the port's counterpart of tools/train_bench.py.

The same 14 configurations in the same order, at the JAX tool's batches
(its main(), :139-151): CVAE pretraining (zdim 128, num_samples 5, 3 s
segments) at B 8 and 16 in f32 and bf16, at B 16 and 32 with and without
remat, and B 32 f32; the NSVAE (dual-latent double-channel noisy encoder,
B 25); phase 2 classical and adversarial (B 15); the supervised DCCRN
(B 48) in bf16 and f32. Each step is forward, backward and the
optimizers' updates on a batch that lives on the card; 2 warm steps,
then a window of 8 steps closed by a scalar fetch of the last loss.
`audio_s_per_s` = batch x 3 s / step time (:129-131). A configuration
that does not fit records status 'oom' (torch.cuda.OutOfMemoryError
only; every other exception propagates).

  python -m idccrn_vae_torch.tools.train_bench [--steps 8]
      [--only 0,3] [--tiny --device cpu]

writes TRAIN_BENCH_TORCH.json (or --out) with the card record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.tools import common

SECONDS = 3.0
STEPS = 8
WARM = 2
# (trainer, batch, compute, remat): tools/train_bench.py:139-151
CONFIGS = (
    ("pretrain", 8, "f32", False), ("pretrain", 8, "bf16", False),
    ("pretrain", 16, "f32", False), ("pretrain", 16, "bf16", False),
    ("pretrain", 16, "bf16", True), ("pretrain", 32, "bf16", False),
    ("pretrain", 32, "bf16", True), ("pretrain", 32, "f32", False),
    ("nsvae", 25, "bf16", False), ("phase2", 15, "bf16", False),
    ("phase2_adv", 15, "bf16", False), ("supervised", 48, "bf16", False),
    ("supervised", 48, "f32", False),
)
# waveforms per batch of each trainer
_SIGNALS = {"pretrain": 1, "nsvae": 3, "phase2": 3, "phase2_adv": 3,
            "supervised": 2}


def make_trainer(kind: str, compute: str, remat: bool, geo: dict, device):
    """The JAX tool's trainer of `kind` (:84-126), on `device`."""
    if kind == "pretrain":
        from idccrn_vae_torch.losses.vae_loss import (
            PretrainVaeLoss,
            kl_annealing_schedule,
        )
        from idccrn_vae_torch.train.pretrain import PretrainTrainer

        cfg = DccrnConfig(causal=True, num_samples=5, compute=compute,
                          remat=remat, **geo)
        loss = PretrainVaeLoss(kl_annealing_schedule(20), 1.0, num_samples=5)
        return PretrainTrainer(cfg, loss, 1e-3, device=device)
    if kind == "nsvae":
        from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
        from idccrn_vae_torch.train.nsvae import NsvaeTrainer

        pre = DccrnConfig(causal=True, num_samples=5, compute=compute,
                          remat=remat, **geo)
        noisy = dataclasses.replace(pre, latent_num=2, channel_mode="double")
        loss = NsvaeTrueKlLoss(alpha=1.0, w_resi=0.1, w_kl=1.0,
                               w_dismiu=0.1, cfg=noisy, matching="both")
        return NsvaeTrainer(pre, noisy, loss, 1e-3, device=device)
    if kind in ("phase2", "phase2_adv"):
        from idccrn_vae_torch.losses.phase2 import TwoPhaseLoss
        from idccrn_vae_torch.train.phase2 import Phase2Trainer

        enc = DccrnConfig(causal=True, num_samples=5, latent_num=1,
                          compute=compute, remat=remat, **geo)
        dec = dataclasses.replace(enc, skip_mode="runtime", recon_type="mask")
        return Phase2Trainer(enc, dec, TwoPhaseLoss((1.0, 1.0, 0.0), 1.0, 1),
                             1e-3, adversarial=kind == "phase2_adv",
                             d_step=1, device=device)
    from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    cfg = DccrnConfig(causal=True, lstm_hidden=128, recon_type="mask",
                      compute=compute, remat=remat, **geo)
    return SupervisedTrainer(cfg, EteTrainSeLoss((1.0, 1.0, 1.0)), 1e-3,
                             device=device)


def make_batch(kind: str, b: int, n: int, device, seed: int = 0):
    """The JAX tool's `_wav` batches (0.1 N(0, 1)), on the device."""
    rng = np.random.default_rng(seed)
    wavs = tuple(torch.from_numpy(
        (0.1 * rng.standard_normal((b, n))).astype(np.float32)).to(device)
        for _ in range(_SIGNALS[kind]))
    return wavs if len(wavs) > 1 else wavs[0]


def time_steps(trainer, batch, steps: int, device) -> dict:
    """2 warm steps, then `steps` timed ones; status 'oom' when the card
    runs out of memory."""
    gen = torch.Generator(device).manual_seed(0)
    step = lambda: trainer.train_step(batch, gen, 0)
    try:
        common.reset_peak(device)
        dt = common.time_calls(step, steps, device, warm=WARM)
        metrics = step()
        rec = {"status": "ok", "step_ms": 1e3 * dt,
               "loss": float(metrics["total"]),
               "peak_gib": common.peak_gib(device)}
        return rec
    except torch.cuda.OutOfMemoryError as e:
        return {"status": "oom", "detail": str(e)[:200]}


def bench(kind, b, compute, remat, geo, n, seconds, steps, device) -> dict:
    rec = {"trainer": kind, "batch": b, "compute": compute}
    if kind == "pretrain":
        rec.update(remat=remat, num_samples=5)
    trainer = batch = None
    try:
        trainer = make_trainer(kind, compute, remat, geo, device)
        batch = make_batch(kind, b, n, device)
        rec.update(time_steps(trainer, batch, steps, device))
    except torch.cuda.OutOfMemoryError as e:
        rec.update(status="oom", detail=str(e)[:200])
    finally:
        del trainer, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if rec["status"] == "ok":
        rec["audio_s_per_s"] = b * seconds / (rec["step_ms"] / 1e3)
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_args(p, "TRAIN_BENCH_TORCH.json")
    p.add_argument("--steps", type=int, default=None,
                   help=f"timed steps per configuration (default {STEPS})")
    p.add_argument("--only", default=None,
                   help="comma list of configuration indices")
    args = p.parse_args(argv)
    device = common.device_of(args)
    geo = common.geometry(args.tiny)
    seconds = 0.1 if args.tiny else SECONDS
    n = int(seconds * common.FS)
    steps = args.steps or (1 if args.tiny else STEPS)
    picked = (range(len(CONFIGS)) if args.only is None
              else [int(i) for i in args.only.split(",")])
    report = {"tool": "idccrn_vae_torch.tools.train_bench",
              "counterpart": "tools/train_bench.py",
              "card": common.card_record(device),
              "geometry": {**geo, "causal": True, "tiny": args.tiny},
              "fs": common.FS, "seconds": seconds,
              "T_frames": n // 100 + 1, "steps_timed": steps,
              "warm_steps": WARM, "results": []}
    for i in picked:
        kind, b, compute, remat = CONFIGS[i]
        if args.tiny:
            b = 2
        rec = bench(kind, b, compute, remat, geo, n, seconds, steps, device)
        report["results"].append(rec)
        print(json.dumps(rec), flush=True)
    common.write_report(args.out, report)
    print(f"wrote {os.path.abspath(args.out)}")
    return report


if __name__ == "__main__":
    main()
