"""The readings that each limit of `correct` is set from, on the card, at
the cell's own size: the compared numbers of the program over many
seeds, of the control (the step below the configuration's precision
that would tempt a later change), and of a training cell's planted
fault. One process runs every seed of a side; each seed runs a
short window of the cell's own traffic and compares as many answers as
a run does.

Sides: `program`, the cell as it runs, and those of the cell's traffic
module, `SIDES` (side name -> function of the Run giving an Outcome),
whose `CONTROL` names the control: for eval cells the program's own
int8 serving path (`int8_enc`, `int8_all`), for the training cell the
trainer at bf16 (`bf16`) and a fault (`half_batch`), for the stream the
plain reference at bf16 operands in the program's place (`bf16`).

  python3 benchmark/calibrate.py --workload <cell> --side program
      --seeds 11,12,13 [--seconds 2] [--out readings.jsonl]

prints one JSON line per seed: {"cell", "side", "seed", "checks"}.
"""

from __future__ import annotations

import argparse
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

from benchmark import harness  # noqa: E402


def readings(cell: str, side: str, seed: int, seconds: float,
             device: torch.device) -> harness.Outcome:
    """The Outcome of one seed of `side` in `cell`, its limits infinite
    (nothing is judged here)."""
    bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    here = os.path.join(harness.ROOT, "benchmark")
    config = harness.load_json(here, "configs", f"{entry['config']}.json")
    mix = harness.load_json(here, "traffic", f"{entry['traffic']}.json")
    traffic = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    inf = {k: math.inf for k in harness.load_json(
        here, "workloads", f"{cell}.json")["limits"]}
    run = harness.Run(cell, config, mix, inf, seed, seconds, False, device,
                      time.perf_counter())
    out = (traffic.run if side == "program" else traffic.SIDES[side])(run)
    run.free()
    return out


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
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(args.workload, args.side, seed, args.seconds,
                       torch.device("cuda", 0))
        line = json.dumps({"cell": args.workload, "side": args.side,
                           "seed": seed, "checks": {
                               k: v for k, (v, _) in out.checks.items()},
                           "notes": out.notes,
                           "seconds": time.perf_counter() - t0})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
