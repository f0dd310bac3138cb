"""The harness: BENCHMARK.json against the contract's form, every file
found by name, each traffic module run for a second at the tests' width
on the CPU through the harness, a cell joined as new files alone, the
refusal without a card, and (marked `card`) each cell for a few seconds
on a card."""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import ROOT, small_mix, tiny_config

HERE = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
RESULT_KEYS = ("correct", "attempted", "failed", "metrics", "device")


def bench(root: str = ROOT) -> dict:
    return harness.load_json(root, "BENCHMARK.json")


def test_benchmark_json_form():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= b["run_seconds"] <= 51
    names = []
    for section, keys in KEYS.items():
        for entry in b[section]:
            assert keys <= set(entry) <= keys | {"workloads"}, entry
            assert NAME.match(entry["name"]), entry["name"]
            names.append(entry["name"])
            for k in ("why", "layer", "source"):
                if k in entry:
                    assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", cells)
            assert cell in reported, (m["name"], cell)
    for cell in cells:
        got, layer = harness.cell_metrics(b, cell)
        assert len(got) >= 2 and "setup_s" in {m["name"] for m in got}
        assert layer
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/") and not c["reduced"]


def test_files_found_by_name():
    """Every name in BENCHMARK.json has its file, every file under
    configs/, workloads/ and metrics/ has its name, and every
    configuration and traffic file its CPU tests' size under tests/."""
    b = bench()
    for data, size in (("configs", "tiny"), ("traffic", "small")):
        want = {f for f in os.listdir(os.path.join(HERE, data))
                if f.endswith(".json")}
        have = set(os.listdir(os.path.join(HERE, "tests", size)))
        assert not want - have, \
            f"no CPU test size in benchmark/tests/{size}/ for {want - have}"
        assert not have - want, f"benchmark/tests/{size}/: {have - want}"
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert harness.load_json(ROOT, c["file"])["name"] == c["name"]
    assert {f[:-5] for f in os.listdir(os.path.join(HERE, "configs"))} \
        == configs
    cells = {w["name"] for w in b["workloads"]}
    assert {f[:-5] for f in os.listdir(os.path.join(HERE, "workloads"))} \
        == cells
    for w in b["workloads"]:
        limits = harness.load_json(HERE, "workloads", f"{w['name']}.json")
        assert limits["limits"] and all(v > 0 for v in
                                        limits["limits"].values())
        mix = harness.load_json(HERE, "traffic", f"{w['traffic']}.json")
        for path in (("traffic", f"{mix['kind']}.py"),
                     ("tests", "faults", f"{mix['kind']}.py")):
            assert os.path.exists(os.path.join(HERE, *path)), path
        kind = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
        assert kind.CONTROL in kind.SIDES
    readers = harness.metric_readers()
    assert set(readers) == {m["name"] for m in b["per_layer"]}


def small_run(cell: str, trace: bool, seconds: float = 1.0,
              compute: str = None, root: str = ROOT, seed: int = 2**33 + 5):
    """run_cell at the tests' width and a small mix, on the CPU."""
    entry = next(w for w in bench(root)["workloads"] if w["name"] == cell)
    config = tiny_config(entry["config"], root)
    if compute:
        for use in ("serve", "train", "stream"):
            if use in config:
                config[use]["compute"] = compute
    return harness.run_cell(cell, seed, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), root=root, config=config,
                            mix=small_mix(entry["traffic"], root))


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
@pytest.mark.parametrize("trace", [False, True])
def test_traffic_runs_on_the_cpu(cell, trace):
    torch.set_num_threads(2)
    line = small_run(cell, trace, compute="f32")
    assert list(line)[: len(RESULT_KEYS)] == list(RESULT_KEYS)
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e, layer = harness.cell_metrics(bench(), cell)
    if trace:
        # on the CPU the trace holds no device op: only the readers of
        # host counts report
        assert set(line["metrics"]) <= {m["name"] for m in layer}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        assert all(v["value"] > 0 for v in line["metrics"].values())


def test_cell_joins_as_files_alone(tmp_path):
    """A cell with a mix of a new name joins by new files and entries
    added to BENCHMARK.json's lists alone: in a copy of the benchmark's
    files, the mix, its CPU test size and the cell's limits, and a
    traced run of it at the tests' width comes out correct with its
    per-layer metrics, read by the readers found by name."""
    root = str(tmp_path)
    for folder in ("configs", "traffic", "workloads", "metrics",
                   os.path.join("tests", "small"),
                   os.path.join("tests", "tiny")):
        shutil.copytree(os.path.join(HERE, folder),
                        os.path.join(root, "benchmark", folder),
                        ignore=shutil.ignore_patterns("__pycache__"))

    def write(data, *parts):
        with open(os.path.join(root, *parts), "w") as f:
            json.dump(data, f)

    b, cell, twin = bench(), "idccrn_vae_z128.join_s2_b3", \
        "idccrn_vae_z128.eval_s10"
    write({"kind": "eval_utterances", "why": "a mix added as data",
           "batch_size": 3, "num_samples": 2,
           "pool": [{"count": 3, "seconds": 1.0}]},
          "benchmark", "traffic", "join_s2_b3.json")
    write({"pool": [{"count": 3, "seconds": 0.5}]},
          "benchmark", "tests", "small", "join_s2_b3.json")
    write(harness.load_json(HERE, "workloads", f"{twin}.json"),
          "benchmark", "workloads", f"{cell}.json")
    b["workloads"].append({"name": cell, "config": "idccrn_vae_z128",
                           "traffic": "join_s2_b3", "chips": 1,
                           "why": "a cell added as data"})
    for m in b["end_to_end"] + b["per_layer"]:
        if twin in m.get("workloads", []):
            m["workloads"].append(cell)
    write(b, "BENCHMARK.json")
    torch.set_num_threads(2)
    line = small_run(cell, True, compute="f32", root=root)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] % 3 == 0 and line["failed"] == 0
    _, layer = harness.cell_metrics(b, cell)
    assert {"pad_share.enhance", "lstm_ms.enhance"} <= set(line["metrics"]) \
        <= {m["name"] for m in layer}


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = bench()["workloads"][0]["name"]
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""


def check_line(line: dict, cell: str, trace: bool) -> None:
    """The result line against the contract."""
    assert list(line)[: len(RESULT_KEYS)] == list(RESULT_KEYS)
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    e2e, layer = harness.cell_metrics(bench(), cell)
    want = layer if trace else e2e
    assert set(line["metrics"]) == {m["name"] for m in want}
    for m in want:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        for key in ("device_ops", "idle_gaps"):
            assert len(line["breakdown"][key]) <= 10
    for name, value in line["metrics"].items():
        if "mfu" in name or "roofline" in name:
            assert 0 < value["value"] <= 100


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, cell, trace):
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2**32 + 3), "--seconds", "3",
                        "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    check_line(line, cell, bool(trace))
    assert line["correct"] is True, line["checks"]


class FakeEvent:
    """The methods of torch's _KinetoEvent that devtrace reads."""

    def __init__(self, name, device, start, end, corr=0, linked=0):
        self._v = (name, device, start, end, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_trace_summary():
    """Busy time is the union of device intervals inside the stretch;
    kernels count apart from copies; device time goes to the launching
    op; a gap is named after the op that ends it, and outside the marks
    it is the paced wait."""
    from torch.autograd import DeviceType

    from benchmark import devtrace

    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        FakeEvent(devtrace.STRETCH, cpu, 0, 1000),
        FakeEvent(devtrace.STRETCH, gpu, 0, 1000),
        FakeEvent(devtrace.MARK, cpu, 100, 600),
        FakeEvent("aten::cudnn_convolution", cpu, 100, 120, corr=1),
        FakeEvent("aten::mm", cpu, 130, 140, corr=2),
        FakeEvent("cudaLaunchKernel", cpu, 101, 105, corr=9, linked=1),
        FakeEvent("conv_kernel", gpu, 200, 400, linked=1),
        FakeEvent("gemm_kernel", gpu, 300, 500, linked=2),
        FakeEvent("Memcpy DtoH (Device -> Pinned)", gpu, 550, 560, linked=2),
        FakeEvent("conv_kernel", gpu, 900, 950, linked=1),
    ]
    t = devtrace.summarize(events)
    assert t.window_s == 1000e-9 and t.kernels == 3
    assert t.busy_s == pytest.approx((300 + 10 + 50) * 1e-9)
    assert t.busy_in_marks_s == pytest.approx(310e-9)
    assert t.marks_s == pytest.approx(500e-9)
    assert t.seconds_under("conv") == pytest.approx(250e-9)
    assert t.seconds_under("matmul") == pytest.approx(210e-9)
    # 0-200: 100 before the mark, 100 inside; 560-900: 40 inside
    assert t.gap_s["aten::cudnn_convolution"] == pytest.approx(140e-9)
    assert t.gap_s["aten::mm"] == pytest.approx(50e-9)
    # outside the mark: 0-100, 600-900 and 950-1000
    assert t.gap_s["paced wait"] == pytest.approx(450e-9)
