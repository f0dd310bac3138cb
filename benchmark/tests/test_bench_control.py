"""Each cell's control comes out not correct on the card, and the
program correct, at the cell's own size with a short window (one pass,
three steps and a 5 s stream), one seed. The control is the side that
the cell's traffic module names (`CONTROL`, run by
benchmark/calibrate.py): the eval cells' own int8 serving path, the
trainer at bf16, the plain reference at bf16 operands in the stream's
place. The readings over many seeds that the limits are set from are
listed in PERF.md. On the CPU, at the tests' width: every side runs and
the control parts from the program."""

import importlib
import math
import os
import time

import pytest
import torch

from benchmark import calibrate, harness
from benchmark.tests.conftest import small_mix, tiny_config

HERE = os.path.join(harness.ROOT, "benchmark")
CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_sides_on_the_cpu(cell):
    """Each side of the cell's traffic kind, at the tests' width in
    float32: the control reads a hundred times the program's round-off
    or more."""
    torch.set_num_threads(2)
    config_name, traffic = cell.split(".")
    config, mix = tiny_config(config_name), small_mix(traffic)
    for use in ("serve", "train", "stream"):
        if use in config:
            config[use]["compute"] = "f32"
    kind = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    limits = harness.load_json(HERE, "workloads", f"{cell}.json")["limits"]
    got = {}
    for side in ["program", *kind.SIDES]:
        run = harness.Run(cell, config, mix, {k: math.inf for k in limits},
                          2**33 + 9, 0.5, False, torch.device("cpu"),
                          time.perf_counter())
        out = (kind.run if side == "program" else kind.SIDES[side])(run)
        got[side] = max(v for v, _ in out.checks.values())
    assert got[kind.CONTROL] > 100 * got["program"], got


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_holds(card, cell):
    torch.set_num_threads(2)
    entry = next(w for w in harness.load_json(
        harness.ROOT, "BENCHMARK.json")["workloads"] if w["name"] == cell)
    kind = harness.load_json(HERE, "traffic",
                             f"{entry['traffic']}.json")["kind"]
    control = importlib.import_module(f"benchmark.traffic.{kind}").CONTROL
    limits = harness.load_json(HERE, "workloads", f"{cell}.json")["limits"]

    def values(side):
        out = calibrate.readings(cell, side, 101, 5.0, card)
        return {k: v for k, (v, _) in out.checks.items()}
    got = values("program")
    assert all(got[k] <= limits[k] for k in limits), (got, limits)
    bad = values(control)
    assert any(bad[k] > limits[k] for k in limits), (bad, limits)
