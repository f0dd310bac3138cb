"""Enhancement RTFx of the serving programs on one card: the port's
counterpart of bench.py's `measure()`.

Programs (bench.py:172-216), at the reference geometry (zdim 128,
channels 1-32-64-128-128-256-256, causal, 16 kHz), num_samples 1,
pad_mode 'sig', with random weights from seeded CPU generators:
  clean_direct       NsvaeEncoder -> split_noisy_skips -> VaeDecoder,
                     the reconstruction of the speech latent
  dual_complex_mask  the latent_num 2 serving program through the port's
                     Enhancer: double-channel dual-latent encoder, speech
                     and noise decoders, complex ratio mask

Method (bench.py:218-239): per batch a 3 s input `wav`, a warm window of
2 iterations, then a window of 150 iterations, each enhancing
`wav + 1e-6 * out` (the previous output fed back, fresh latent draws
from one generator), closed by a scalar fetch. RTFx = iterations x batch
x 3 s / window seconds. The JAX bench runs its window as one
`lax.fori_loop` dispatch; here it is an eager chain of launches from the
host, so at B=32, where launches are short, the window measures the host
as much as the card.

Output: per run (program, compute) bench.py's line, {"metric":
"enhance_rtfx_per_chip", "value": the best batch's RTFx, "unit":
"x_realtime", "vs_baseline": value / 300, ...}, printed to stdout; the
file --out holds every run with per-batch RTFx, ms per batch, peak
memory, and the card record. bench.py's TPU probe, retry
loop and watchdog are not ported (TPU machinery).

  python -m idccrn_vae_torch.tools.bench [--runs clean_direct:bf16,...]
      [--batches 32,128] [--iters 150] [--tiny --device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Callable

import torch

from idccrn_vae_torch.models.config import DccrnConfig
from idccrn_vae_torch.tools import common

PROGRAMS = ("clean_direct", "dual_complex_mask")
COMPUTES = ("f32", "bf16", "int8")
DEFAULT_RUNS = "clean_direct:bf16,clean_direct:int8,dual_complex_mask:bf16"
SECONDS = 3.0
ITERS = 150
BASELINE_RTFX = 300.0  # BASELINE.json's north-star per card


def configs(program: str, compute: str, geo: dict):
    """(encoder config, decoder config) of a program (bench.py:172-207)."""
    if program == "clean_direct":
        cfg = DccrnConfig(causal=True, num_samples=1, latent_num=1,
                          compute=compute, **geo)
        return cfg, cfg
    enc = DccrnConfig(causal=True, num_samples=1, latent_num=2,
                      channel_mode="double", compute=compute, **geo)
    return enc, dataclasses.replace(enc, latent_num=1, channel_mode="normal")


def random_weights(program: str, enc_cfg, dec_cfg, seed: int = 0):
    """State dicts of seeded random weights: (encoder, decoder[, noise
    decoder])."""
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder
    from idccrn_vae_torch.models.vae import VaeDecoder

    gen = lambda k: torch.Generator().manual_seed(seed + k)
    out = [NsvaeEncoder(enc_cfg, device="cpu", generator=gen(0)),
           VaeDecoder(dec_cfg, device="cpu", generator=gen(1))]
    if program == "dual_complex_mask":
        out.append(VaeDecoder(dec_cfg, device="cpu", generator=gen(2)))
    return tuple(m.state_dict() for m in out)


def clean_direct(cfg: DccrnConfig, enc_state, dec_state,
                 device: torch.device) -> Callable:
    """bench.py:200-216: (wav, generator, noise) -> the reconstruction
    (B, (T - 1) * hop); `noise` optionally gives the latent draws."""
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder, split_noisy_skips
    from idccrn_vae_torch.models.vae import VaeDecoder

    enc = NsvaeEncoder(cfg, device=device)
    enc.load_state_dict(enc_state)
    dec = VaeDecoder(cfg, device=device)
    dec.load_state_dict(dec_state)
    enc.eval()
    dec.eval()

    @torch.inference_mode()
    def enhance(wav, generator=None, noise=None):
        out = enc(wav, num_samples=1, generator=generator, noise=noise)
        skips = split_noisy_skips(out.skips, cfg, "speech")
        recon, _ = dec(out.stft_x, out.z_speech, skips, num_samples=1,
                       pad_mode="sig")
        return recon

    return enhance


def dual_complex_mask(enc_cfg, dec_cfg, states, device) -> Callable:
    """bench.py:172-199, through the port's Enhancer."""
    from idccrn_vae_torch.eval.enhance import Enhancer

    enh = Enhancer(enc_cfg, dec_cfg, *states, num_samples=1,
                   outtype="complex_mask", latent_to_use=2, pad_mode="sig",
                   device=device)
    return enh.forward


def build(program: str, compute: str, geo: dict, device: torch.device,
          seed: int = 0) -> Callable:
    enc_cfg, dec_cfg = configs(program, compute, geo)
    states = random_weights(program, enc_cfg, dec_cfg, seed)
    if program == "clean_direct":
        return clean_direct(enc_cfg, *states, device)
    return dual_complex_mask(enc_cfg, dec_cfg, states, device)


def measure(enhance: Callable, batch: int, seconds: float, iters: int,
            device: torch.device, seed: int = 7) -> dict:
    """One batch's chained window (bench.py:218-239)."""
    n = int(common.FS * seconds)
    gen = torch.Generator(device).manual_seed(seed)
    wav = 0.1 * torch.randn(batch, n, generator=gen, device=device)
    carry = {"out": wav}

    def step():
        carry["out"] = enhance(wav + 1e-6 * carry["out"], gen)
        return carry["out"]

    common.reset_peak(device)
    dt = common.time_calls(step, iters, device, warm=2)
    if not bool(torch.isfinite(carry["out"]).all()):
        raise FloatingPointError(f"non-finite output at B={batch}")
    rec = {"batch": batch, "rtfx": batch * seconds / dt,
           "ms_per_batch": 1e3 * dt, "peak_gib": common.peak_gib(device),
           "out_shape": list(carry["out"].shape)}
    return rec


def bench_run(program: str, compute: str, geo: dict, batches, seconds,
              iters, device) -> dict:
    enhance = build(program, compute, geo, device)
    records = [measure(enhance, b, seconds, iters, device) for b in batches]
    best = max(r["rtfx"] for r in records)
    line = {"metric": "enhance_rtfx_per_chip", "value": best,
            "unit": "x_realtime", "vs_baseline": best / BASELINE_RTFX}
    if compute != "bf16":
        line["compute"] = compute
    if program != "clean_direct":
        line["program"] = program
    return {"program": program, "compute": compute, "line": line,
            "batches": records}


def parse_runs(text: str):
    runs = []
    for item in text.split(","):
        program, compute = item.split(":")
        if program not in PROGRAMS or compute not in COMPUTES:
            raise SystemExit(f"unknown run {item!r}: programs {PROGRAMS}, "
                             f"computes {COMPUTES}")
        runs.append((program, compute))
    return runs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    common.add_args(p, "SERVE_BENCH_TORCH.json")
    p.add_argument("--runs", default=DEFAULT_RUNS,
                   help="comma list of program:compute")
    p.add_argument("--batches", default=None,
                   help="comma list (default 32,128; --tiny 2)")
    p.add_argument("--iters", type=int, default=None,
                   help=f"timed iterations per batch (default {ITERS})")
    p.add_argument("--seconds", type=float, default=None,
                   help=f"clip length (default {SECONDS}; --tiny 0.4)")
    args = p.parse_args(argv)
    runs = parse_runs(args.runs)
    device = common.device_of(args)
    geo = common.geometry(args.tiny)
    batches = (tuple(int(b) for b in args.batches.split(","))
               if args.batches else ((2,) if args.tiny else (32, 128)))
    iters = args.iters or (2 if args.tiny else ITERS)
    seconds = args.seconds or (0.4 if args.tiny else SECONDS)
    report = {"tool": "idccrn_vae_torch.tools.bench",
              "counterpart": "bench.py measure()",
              "card": common.card_record(device),
              "geometry": {**geo, "causal": True, "num_samples": 1,
                           "pad_mode": "sig", "tiny": args.tiny},
              "seconds": seconds, "iters": iters, "warm_iters": 2,
              "batches": list(batches), "runs": []}
    for program, compute in runs:
        run = bench_run(program, compute, geo, batches, seconds, iters,
                        device)
        report["runs"].append(run)
        print(json.dumps(run["line"]), flush=True)
    common.write_report(args.out, report)
    print(f"wrote {os.path.abspath(args.out)}")
    return report


if __name__ == "__main__":
    main()
