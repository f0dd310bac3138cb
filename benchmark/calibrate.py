"""The readings that each limit of `correct` is set from, on the card, at
the cell's own size: the compared numbers of the program over many
seeds, of the control (the step below the configuration's precision
that would tempt a later change), and of a training cell's planted
fault. One process runs every seed of a side; each seed runs a
short window of the cell's own traffic and compares as many answers as
a run does.

Sides:
  program      the cell as it runs
  int8_enc     eval cells' control: the program's own int8 serving path
  int8_all     (quant_scope 'enc' and 'all')
  bf16         the training cell's control: the trainer at bf16; the
               stream cell's: the plain reference with bf16 operands in
               the program's place
  half_batch   a training fault: each step on half of its batch and
               draws, the loss's mean taken over the rest (a state left
               unchanged reads 1 and needs no run)

  python3 benchmark/calibrate.py --workload <cell> --side program
      --seeds 11,12,13 [--seconds 2] [--out readings.jsonl]

prints one JSON line per seed: {"cell", "side", "seed", "checks"}.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import math
import os
import sys
import time

if __name__ == "__main__":
    # the checkout's root heads the import path, as in run.py
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import harness, programs  # noqa: E402


class HalfBatch:
    """A trainer whose steps see half of their batch and draws."""

    def __init__(self, trainer):
        self.inner = trainer

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def train_step(self, batch, generator, epoch, noise=None):
        h = len(batch) // 2
        return self.inner.train_step(batch[:h], generator, epoch,
                                     noise=tuple(e[:h] for e in noise))


def build_for(kind: str, side: str):
    """The `build` that the traffic module `kind`'s run() takes for
    `side`."""
    base = {"eval_utterances": programs.enhancer,
            "train_step": programs.trainer,
            "stream_paced": programs.streamer}[kind]
    if side == "program":
        return base
    if side in ("int8_enc", "int8_all"):
        return functools.partial(base, compute="int8",
                                 quant_scope=side.split("_")[1])
    if side == "bf16" and kind == "train_step":
        return functools.partial(base, compute="bf16")
    if side == "half_batch":
        return lambda *a, **k: HalfBatch(base(*a, **k))
    raise ValueError(f"unknown side {side!r}")


def stream_bf16_gap(run: harness.Run) -> dict:
    """The stream control's chunk_gap: the reference at bf16 operands
    against the reference at float32, on the audio of a run."""
    from benchmark import inputs
    from benchmark.reference import model as ref
    from benchmark.traffic.stream_paced import chunk_gap, reference_stream

    config, mix, dev = run.config, run.mix, run.device
    hop = config["stft"]["hop"]
    m = mix["chunk_frames"] * hop
    period = m / config["stft"]["fs"]
    n = max(1, round(run.seconds / period))
    weights = inputs.make_weights(programs.layouts(config, "stream"),
                                  run.seed, dev)
    audio = inputs.stream_audio(n * period, run.seed, config["stft"]["fs"])
    want = reference_stream(audio, weights, config, dev)
    got = reference_stream(audio, weights, config, dev, ref.BF16)
    return {"chunk_gap": chunk_gap(got, want, m,
                                   config["stft"]["n_fft"] - hop)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", default="program")
    p.add_argument("--seeds", required=True,
                   help="comma list of seeds")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None, help="also append lines here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == args.workload)
    here = os.path.join(harness.ROOT, "benchmark")
    config = harness.load_json(here, "configs", f"{entry['config']}.json")
    mix = harness.load_json(here, "traffic", f"{entry['traffic']}.json")
    traffic = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    inf = {k: math.inf for k in harness.load_json(
        here, "workloads", f"{args.workload}.json")["limits"]}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(args.workload, config, mix, inf, seed, args.seconds,
                          False, device, t0)
        notes = {}
        if mix["kind"] == "stream_paced" and args.side == "bf16":
            checks = stream_bf16_gap(run)
        else:
            out = traffic.run(run, build=build_for(mix["kind"], args.side))
            checks = {k: v for k, (v, _) in out.checks.items()}
            notes = out.notes
        line = json.dumps({"cell": args.workload, "side": args.side,
                           "seed": seed, "checks": checks, "notes": notes,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        run.free()


if __name__ == "__main__":
    main()
