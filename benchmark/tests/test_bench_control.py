"""Each cell's control comes out not correct on the card, and the
program correct, at the cell's own size with a short window (one pass,
three steps and a 5 s stream), one seed. The controls
(benchmark/calibrate.py): the eval cells' own int8 serving path, the
trainer at bf16, the plain reference at bf16 operands in the stream's
place. The readings over many seeds that the limits are set from are
listed in PERF.md."""

import math
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.conftest import load_config

HERE = os.path.join(harness.ROOT, "benchmark")
CONTROL = {"eval_utterances": "int8_enc", "train_step": "bf16",
           "stream_paced": "bf16"}


def readings(cell: str, side: str, seed: int, device) -> dict:
    entry = next(w for w in harness.load_json(
        harness.ROOT, "BENCHMARK.json")["workloads"] if w["name"] == cell)
    config = load_config(entry["config"])
    mix = harness.load_json(HERE, "traffic", f"{entry['traffic']}.json")
    limits = harness.load_json(HERE, "workloads", f"{cell}.json")["limits"]
    run = harness.Run(cell, config, mix, {k: math.inf for k in limits},
                      seed, 5.0, False, device, time.perf_counter())
    if mix["kind"] == "stream_paced" and side == "bf16":
        return calibrate.stream_bf16_gap(run), limits
    import importlib
    traffic = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    out = traffic.run(run, build=calibrate.build_for(mix["kind"], side))
    run.free()
    return {k: v for k, (v, _) in out.checks.items()}, limits


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]])
def test_control_fails_program_holds(card, cell):
    torch.set_num_threads(2)
    mix = harness.load_json(HERE, "traffic", f"{cell.split('.')[1]}.json")
    got, limits = readings(cell, "program", 101, card)
    assert all(got[k] <= limits[k] for k in limits), (got, limits)
    bad, _ = readings(cell, CONTROL[mix["kind"]], 101, card)
    assert any(bad[k] > limits[k] for k in limits), (bad, limits)
