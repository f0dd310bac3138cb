"""The benchmark's frame: one run of one cell, driven by `BENCHMARK.json`
and the files it names.

A cell `<config>.<traffic>` joins
  configs/<config>.json       the model's geometry, precision and recipe
  traffic/<traffic>.json      the traffic mix, whose "kind" names
  traffic/<kind>.py           the code that builds the program, warms it
                              up, runs the window and checks the answers
  workloads/<cell>.json       the cell's limits of the compared numbers
  tests/tiny/<config>.json    the CPU tests' width of the configuration
  tests/small/<traffic>.json  the CPU tests' size of the mix
  tests/faults/<kind>.py      the faults a run of the kind can have
and its metrics are the entries of BENCHMARK.json that list it; each
per-layer metric is read by metrics/<metric>.py from the run's facts.
A later cell, mix, kind, configuration or metric is new files, found by
their names, and entries added to BENCHMARK.json's lists.

A run: set-up (counted from the process's start to the window's
opening), the window (`--seconds` of work, the end-to-end metrics),
with `--trace 1` a traced stretch after it (the per-layer metrics), then
the check of the window's answers against the plain reference, once the
program's state is freed. The last line of standard output is the
result; the numbers compared are the last lines of standard error and
the result's last key.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from benchmark import compare, devtrace, spans

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level modules of the JAX side that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "idccrn_vae_tpu",
             "port_tools", "tools", "bench")
PEAK_TFLOPS = {"bf16": 989.4, "tf32": 494.7, "fp32": 66.9}
PEAK_SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5, dense "
               "(no sparsity), 700 W")


def peak_for(compute: str) -> float:
    """TF/s a program's FLOPs are held against: bf16 runs on the bf16
    tensor cores; float32 convolutions on TF32 tensor cores while cuDNN's
    TF32 is on (torch's default), else on the FP32 units."""
    if compute in ("bf16", "int8"):
        return PEAK_TFLOPS["bf16"]
    if torch.backends.cudnn.allow_tf32:
        return PEAK_TFLOPS["tf32"]
    return PEAK_TFLOPS["fp32"]


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Facts:
    """What a run measured, for the per-layer readers. The traced
    stretch gives `trace` (by kernel and launching op), `spans` (by the
    program's spans) and `counters` (the change in the registered
    program's counters over it); `trace_work` is the work it did."""

    kind: str
    work: Dict[str, float] = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    flops: Optional[float] = None
    peak_tflops: Optional[float] = None
    window_peak_bytes: int = 0
    latencies_ms: list = dataclasses.field(default_factory=list)
    trace: Optional[devtrace.Summary] = None
    spans: Optional[spans.SpanSummary] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace_work: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]
    facts: Facts
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


class Run:
    """One run's settings and clocks, handed to the cell's traffic module.
    The module sets `program` to the system under test where that keeps
    `counters` (a dict of numbers), so that a traced stretch reads them."""

    def __init__(self, cell: str, config: dict, mix: dict, limits: dict,
                 seed: int, seconds: float, trace: bool,
                 device: torch.device, t0: float):
        self.cell, self.config, self.mix, self.limits = cell, config, mix, limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t0 = device, t0
        self.setup_s = self.window_s = None
        self.setup_peak = self.window_peak = 0
        self.program = self.spans = None
        self.counters = {}
        self._opened = None

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def open_window(self) -> None:
        """Set-up ends here: every shape of the cell has run."""
        self.sync()
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._opened = time.perf_counter()
        self.setup_s = self._opened - self.t0

    def elapsed(self) -> float:
        return time.perf_counter() - self._opened

    def close_window(self) -> None:
        self.sync()
        self.window_s = time.perf_counter() - self._opened
        if self.device.type == "cuda":
            self.window_peak = torch.cuda.max_memory_allocated(self.device)

    def traced(self, fn: Callable):
        """(fn(), devtrace.Summary) of a traced stretch after the window;
        keeps the same profile's reduction by span in `spans` and the
        change in the program's counters over the stretch in
        `counters`."""
        before = dict(getattr(self.program, "counters", {}))
        result, summary, self.spans = spans.traced(fn, self.device)
        after = getattr(self.program, "counters", {})
        self.counters = {k: v - before.get(k, 0) for k, v in after.items()}
        return result, summary

    def free(self) -> None:
        """Return the program's memory before the reference runs."""
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def metric_readers(root: str = ROOT) -> Dict[str, Callable]:
    """{metric name: read(facts)} from benchmark/metrics/<name>.py."""
    out = {}
    folder = os.path.join(root, "benchmark", "metrics")
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".py"):
            continue
        name = fname[:-3]
        spec = importlib.util.spec_from_file_location(
            "benchmark_metric_" + name.replace(".", "_"),
            os.path.join(folder, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.read
    return out


def cell_metrics(bench: dict, cell: str):
    """(end-to-end entries, per-layer entries) the cell reports."""
    def has(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in bench["end_to_end"] if has(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if cell in m["workloads"]
             or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> list:
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


def card_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def power_limit() -> Optional[str]:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip()


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float, root: str = ROOT,
             config: Optional[dict] = None, mix: Optional[dict] = None) -> dict:
    """One run of `cell`; returns the result line as a dict. `config`
    and `mix` replace the cell's files (the tests' tiny sizes)."""
    bench = load_json(root, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    here = os.path.join(root, "benchmark")
    if config is None:
        config = load_json(here, "configs", f"{entry['config']}.json")
    if mix is None:
        mix = load_json(here, "traffic", f"{entry['traffic']}.json")
    limits = load_json(here, "workloads", f"{cell}.json")["limits"]
    traffic = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    run = Run(cell, config, mix, limits, seed, seconds, trace, device, t0)
    out: Outcome = traffic.run(run)
    out.facts.spans, out.facts.counters = run.spans, run.counters
    notes = dict(out.notes)
    if run.spans is not None:
        notes["spans"] = run.spans.note()
    if run.counters:
        notes["counters"] = run.counters
    for key, value in notes.items():
        print(f"note {key} {value!r}", file=sys.stderr)
    e2e, layer = cell_metrics(bench, cell)
    metrics = {}
    if trace:
        readers = metric_readers(root)
        for m in layer:
            value = readers[m["name"]](out.facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.e2e, setup_s=run.setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": card_name(device), "count": 1,
           "memory_peak_bytes": max(run.setup_peak, run.window_peak)}
    line = {"correct": None, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": dev}
    tr = out.facts.trace
    if trace and tr is not None:
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = tr.breakdown()
    line["card"] = {"power_limit": power_limit() if device.type == "cuda"
                    else None, "peak_source": PEAK_SOURCE}
    line["correct"] = out.failed == 0 and all(
        compare.within(v, lim) for v, lim in out.checks.values())
    line["checks"] = compare.report(out.checks)
    return line


def parse(argv):
    p = argparse.ArgumentParser(description="One run of one benchmark cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    bench = load_json(ROOT, "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"needs {entry['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), torch.device("cuda", 0), t0)
    except Exception:
        traceback.print_exc()
        return 1
    found = forbidden_modules()
    if found:
        print(f"JAX-side modules loaded: {found}", file=sys.stderr)
        return 4
    for v in line["metrics"].values():
        if not math.isfinite(v["value"]):
            print(f"non-finite metric: {line['metrics']}", file=sys.stderr)
            return 5
    print(json.dumps(line), flush=True)
    return 0
