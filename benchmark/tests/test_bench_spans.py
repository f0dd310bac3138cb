"""benchmark/spans.py on hand-made profiler events: device time by the
innermost span around its launch, idle time split at span edges, the
backward thread's launches by time, and devtrace's numbers untouched."""

import math
import time

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import devtrace, harness, spans
from benchmark.tests import test_bench_harness
from benchmark.tests.conftest import tiny_config
from benchmark.tests.test_bench_harness import FakeEvent

CPU, GPU = DeviceType.CPU, DeviceType.CUDA
MAIN, AUTOGRAD = 1, 2


class Event(FakeEvent):
    """FakeEvent with the thread that opened it."""

    def __init__(self, name, device, start, end, corr=0, linked=0,
                 thread=MAIN):
        super().__init__(name, device, start, end, corr, linked)
        self.thread = thread

    def start_thread_id(self):
        return self.thread


def stretch(end=1000):
    return [Event(devtrace.STRETCH, CPU, 0, end),
            Event(devtrace.STRETCH, GPU, 0, end)]


def test_kernel_goes_to_the_innermost_span_of_its_launch():
    events = stretch() + [
        Event("idccrn.enhance.batch", CPU, 10, 900),
        Event("idccrn.lstm", CPU, 100, 300),
        Event("aten::mm", CPU, 150, 160, corr=1),
        Event("aten::add", CPU, 400, 410, corr=2),
        # runs after its span has closed: charged by its launch
        Event("gemm", GPU, 350, 450, linked=1),
        Event("add", GPU, 450, 500, linked=2),
    ]
    s = spans.summarize(events)
    assert s.device_s["idccrn.lstm"] == pytest.approx(100e-9)
    assert s.device_s["idccrn.enhance.batch"] == pytest.approx(50e-9)
    assert s.wall_s == pytest.approx({"idccrn.enhance.batch": 890e-9,
                                      "idccrn.lstm": 200e-9})
    assert s.items_s["idccrn.enhance.batch"] == pytest.approx([890e-9])
    assert s.count == {"idccrn.enhance.batch": 1, "idccrn.lstm": 1}


def test_gap_splits_at_span_edges():
    events = stretch() + [
        Event("idccrn.enhance.batch", CPU, 100, 900),
        Event("idccrn.lstm", CPU, 200, 600),
        Event("aten::mm", CPU, 210, 220, corr=1),
        Event("k", GPU, 300, 400, linked=1),
        Event("k", GPU, 700, 800, linked=1),
    ]
    s = spans.summarize(events)
    # idle: 0-300 (100 outside, 100 batch, 100 lstm), 400-700 (200 lstm,
    # 100 batch), 800-1000 (100 batch, 100 outside)
    assert s.idle_s == pytest.approx({spans.OUTSIDE: 200e-9,
                                      "idccrn.enhance.batch": 300e-9,
                                      "idccrn.lstm": 300e-9})


def test_launch_outside_every_span():
    events = stretch() + [
        Event("idccrn.stream.chunk", CPU, 100, 200),
        Event("aten::copy_", CPU, 300, 310, corr=1),
        Event("Memcpy HtoD", GPU, 320, 330, linked=1),
        Event("orphan", GPU, 400, 420, linked=99),
    ]
    s = spans.summarize(events)
    assert s.device_s == pytest.approx({spans.OUTSIDE: 30e-9})


def test_backward_thread_charged_by_time():
    """Autograd's thread launches inside the main thread's backward span;
    spans that thread opens (a recomputed forward) are not the tree's."""
    events = stretch() + [
        Event("idccrn.train.step", CPU, 0, 1000),
        Event("idccrn.train.forward", CPU, 10, 300),
        Event("idccrn.train.backward", CPU, 300, 800),
        Event("idccrn.lstm", CPU, 400, 500, thread=AUTOGRAD),
        Event("aten::mm", CPU, 450, 460, corr=5, thread=AUTOGRAD),
        Event("mm_backward_kernel", GPU, 470, 600, linked=5),
    ]
    s = spans.summarize(events)
    assert s.device_s == pytest.approx({"idccrn.train.backward": 130e-9})
    assert "idccrn.lstm" not in s.wall_s
    assert s.idle_s["idccrn.train.backward"] == pytest.approx(370e-9)


def test_devtrace_numbers_unchanged_and_the_sums_close():
    """test_trace_summary's events with spans added: devtrace reads the
    same numbers; device seconds by span add up to the trace's, idle
    seconds with the paced wait to the wall less the busy time."""
    cpu, gpu = CPU, GPU
    events = [
        Event(devtrace.STRETCH, cpu, 0, 1000),
        Event(devtrace.STRETCH, gpu, 0, 1000),
        Event(devtrace.MARK, cpu, 100, 600),
        Event("idccrn.stream.chunk", cpu, 100, 590),
        Event("idccrn.enc", cpu, 110, 125),
        Event("aten::cudnn_convolution", cpu, 100, 120, corr=1),
        Event("aten::mm", cpu, 130, 140, corr=2),
        Event("cudaLaunchKernel", cpu, 101, 105, corr=9, linked=1),
        Event("conv_kernel", gpu, 200, 400, linked=1),
        Event("gemm_kernel", gpu, 300, 500, linked=2),
        Event("Memcpy DtoH (Device -> Pinned)", gpu, 550, 560, linked=2),
        Event("conv_kernel", gpu, 900, 950, linked=1),
    ]
    t = devtrace.summarize(events)
    assert t.window_s == 1000e-9 and t.kernels == 3
    assert t.busy_s == pytest.approx((300 + 10 + 50) * 1e-9)
    assert t.busy_in_marks_s == pytest.approx(310e-9)
    assert t.marks_s == pytest.approx(500e-9)
    assert t.seconds_under("conv") == pytest.approx(250e-9)
    assert t.seconds_under("matmul") == pytest.approx(210e-9)
    assert t.gap_s["aten::cudnn_convolution"] == pytest.approx(140e-9)
    assert t.gap_s["aten::mm"] == pytest.approx(50e-9)
    assert t.gap_s["paced wait"] == pytest.approx(450e-9)

    s = spans.summarize(events)
    assert sum(s.device_s.values()) == pytest.approx(sum(t.op_s.values()))
    assert sum(s.idle_s.values()) == pytest.approx(t.window_s - t.busy_s)
    # the launching ops start at 100 (before enc opens) and 130: the chunk
    assert s.device_s == pytest.approx({"idccrn.stream.chunk": 460e-9})
    # inside the mark: 100-200 (110-125 in enc), 500-550 and 560-590 in
    # the chunk, 590-600 outside it
    assert s.idle_s == pytest.approx({"idccrn.stream.chunk": 165e-9,
                                      "idccrn.enc": 15e-9,
                                      spans.OUTSIDE: 10e-9,
                                      spans.PACED: 450e-9})
    assert s.items_s["idccrn.stream.chunk"] == pytest.approx([490e-9])


WANT = {"eval_s10": {"lstm_ms.enhance", "idle_in_lstm.enhance",
                     "pad_share.enhance"},
        "train_b16": {"forward_ms.train", "backward_ms.train",
                      "optimizer_ms.train"},
        "stream_b1": {"chunk_launch_ms.stream", "lstm_ms.stream"}}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  test_bench_harness.bench()["workloads"]])
def test_report_on_the_cpu(cell):
    """A cell's run with its traced stretch reduced by span, at the
    tests' width: on the CPU no device op, so every number but the
    decoder's share of the peak."""
    torch.set_num_threads(2)
    config_name, traffic = cell.split(".")
    config = tiny_config(config_name)
    mix = dict(harness.load_json(test_bench_harness.HERE, "traffic",
                                 f"{traffic}.json"),
               **test_bench_harness.SMALL[traffic])
    line = spans.report(cell, 2**33 + 7, 1.0, torch.device("cpu"),
                        time.perf_counter(), config=config, mix=mix)
    assert line["correct"] is True
    assert set(line["metrics"]) == WANT[traffic]
    assert all(math.isfinite(v) and v > 0 for v in line["metrics"].values())
    t = line["trace"]
    assert line["sums"]["idle_s"] == pytest.approx(
        t["window_s"] - t["busy_s"], rel=1e-9)
    assert max(line["per_item"].values()) <= 15
    if traffic == "eval_s10":
        c = line["counters"]
        assert c["batches"] == 2 and c["rows"] == 4
        assert 0 < c["real_frames"] < c["padded_frames"]
