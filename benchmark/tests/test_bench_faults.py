"""A run with the timed path broken underneath comes out not correct:
the harness's look for a card skipped, the rest of a run driven at the
tests' width on the CPU (float32, so that a sound run reads round-off
alone), once per fault each cell can have: those of its traffic's kind,
in `faults/<kind>.py`. One chip: no exchange between chips to leave
out."""

import importlib

import pytest
import torch

from benchmark.tests.conftest import small_mix
from benchmark.tests.test_bench_harness import bench, small_run


def faults(traffic: str) -> tuple:
    kind = small_mix(traffic)["kind"]
    return importlib.import_module(f"benchmark.tests.faults.{kind}").FAULTS


@pytest.mark.parametrize("cell,fault", [
    (w["name"], fault) for w in bench()["workloads"]
    for fault in faults(w["traffic"])])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    torch.set_num_threads(2)
    fault(monkeypatch)
    line = small_run(cell, False, compute="f32")
    assert line["correct"] is False, line["checks"]
