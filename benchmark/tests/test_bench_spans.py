"""benchmark/spans.py on hand-made profiler events: device time by the
innermost span around its launch, idle time split at span edges, the
backward thread's launches by time, devtrace's numbers untouched, and
each span metric's reader; then each cell's traced run at the tests'
width, on the CPU."""

import ast
import math

import pytest
import torch
from torch.autograd import DeviceType

from benchmark import devtrace, harness, spans
from benchmark.tests import test_bench_harness
from benchmark.tests.conftest import small_mix
from benchmark.tests.test_bench_harness import FakeEvent, small_run

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


WANT = {"eval_utterances": {"lstm_ms.enhance", "idle_in_lstm.enhance",
                            "pad_share.enhance"},
        "train_step": {"forward_ms.train", "backward_ms.train",
                       "optimizer_ms.train"},
        "stream_paced": {"chunk_launch_ms.stream", "lstm_ms.stream"}}
SPAN_METRICS = sorted(set().union(*WANT.values()) | {"dec_mfu.enhance"})


def facts_of(kind: str, events, counters=None, **work) -> harness.Facts:
    """A run's facts as run_cell hands them to the readers."""
    facts = harness.Facts(kind=kind, peak_tflops=989.4, trace_work=work,
                          counters=counters or {})
    facts.trace, facts.spans = (devtrace.summarize(events),
                                spans.summarize(events))
    return facts


def eval_events():
    return stretch(2000) + [
        Event("idccrn.enhance.batch", CPU, 10, 1900),
        Event("idccrn.lstm", CPU, 100, 700),
        Event("aten::mm", CPU, 150, 160, corr=1),
        Event("idccrn.dec", CPU, 800, 1200),
        Event("aten::convolution", CPU, 850, 860, corr=2),
        Event("gemm", GPU, 200, 300, linked=1),
        Event("tconv", GPU, 900, 1300, linked=2),
    ]


def test_span_metric_readers():
    """Each of the span metrics' readers, found by name, gives the
    number worked out by hand here from the same events, counters and
    work, and nothing on another kind's facts."""
    readers = harness.metric_readers()
    counters = {"batches": 1, "rows": 2, "real_frames": 90,
                "padded_frames": 100}
    cases = [
        (facts_of("eval_utterances", eval_events(), counters, audio_s=2.0,
                  dec_flops=1e6),
         {"lstm_ms.enhance": 1e3 * 600e-9 / 2.0,
          # 1500 ns idle, of which 100-200 and 300-700 in the lstm
          "idle_in_lstm.enhance": 100.0 * 500 / 1500,
          "dec_mfu.enhance": 100.0 * 1e6 / (400e-9 * 989.4e12),
          "pad_share.enhance": 10.0}),
        (facts_of("train_step", stretch() + [
            Event("idccrn.train.step", CPU, 0, 1000),
            Event("idccrn.train.forward", CPU, 10, 300),
            Event("idccrn.train.backward", CPU, 300, 800),
            Event("idccrn.train.optimizer", CPU, 800, 990)], steps=2),
         {"forward_ms.train": 1e3 * 290e-9 / 2,
          "backward_ms.train": 1e3 * 500e-9 / 2,
          "optimizer_ms.train": 1e3 * 190e-9 / 2}),
        (facts_of("stream_paced", stretch() + [
            Event("idccrn.stream.chunk", CPU, 0, 300),
            Event("idccrn.lstm", CPU, 100, 150),
            Event("idccrn.stream.chunk", CPU, 400, 600),
            Event("idccrn.stream.chunk", CPU, 700, 1000),
            Event("idccrn.lstm", CPU, 800, 870)], chunks=3),
         {"chunk_launch_ms.stream": 1e3 * 300e-9,
          "lstm_ms.stream": 1e3 * 120e-9 / 3}),
    ]
    for facts, want in cases:
        got = {name: readers[name](facts) for name in SPAN_METRICS}
        assert {k: v for k, v in got.items() if v is not None} \
            == pytest.approx(want)
    # no span reduction, no number
    assert all(readers[name](harness.Facts(kind=kind)) is None
               for kind in WANT for name in SPAN_METRICS)


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  test_bench_harness.bench()["workloads"]])
def test_report_on_the_cpu(cell, capsys, monkeypatch):
    """A cell's traced run at the tests' width through run_cell: on the
    CPU no device op, so every span number but the decoder's share of
    the peak; the span reduction's idle seconds sum to the trace's idle,
    at most 15 spans an item, and the `note spans` and `note counters`
    lines."""
    torch.set_num_threads(2)
    kept = []
    traced = harness.Run.traced

    def keep(run, fn):
        out = traced(run, fn)
        kept.append(run.spans)
        return out

    monkeypatch.setattr(harness.Run, "traced", keep)
    line = small_run(cell, True, seed=2**33 + 7)
    assert line["correct"] is True, line["checks"]
    mix = small_mix(cell.split(".", 1)[1])
    kind = mix["kind"]
    got = {k: v["value"] for k, v in line["metrics"].items()
           if k in SPAN_METRICS}
    assert set(got) == WANT[kind]
    assert all(math.isfinite(v) and v > 0 for v in got.values())
    (sp,) = kept
    dev = line["device"]
    assert sum(sp.idle_s.values()) == pytest.approx(
        dev["window_s"] - dev["busy_s"], rel=1e-9)
    assert max(sum(sp.count.values()) / len(v)
               for v in sp.items_s.values()) <= 15
    notes = {}
    for text in capsys.readouterr().err.splitlines():
        if text.startswith("note "):
            _, key, value = text.split(" ", 2)
            notes[key] = ast.literal_eval(value)
    assert notes["spans"] == sp.note()
    if kind == "eval_utterances":
        c = notes["counters"]
        passes, rest = divmod(c["rows"], 4)
        assert passes >= 1 and rest == 0
        assert c["batches"] == passes * -(-4 // mix["batch_size"])
        assert 0 < c["real_frames"] < c["padded_frames"]
    else:
        assert "counters" not in notes
