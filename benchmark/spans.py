"""The traced stretch's device and idle time charged to the program's
named spans, and the per-layer numbers that read them.

idccrn_vae_torch opens a record function at each layer boundary while a
profiler records (`idccrn_vae_torch/utils/profiling.py` `span`, whose
`SPANS` names them all, each `idccrn.*`), so the spans sit in the same
raw events as the kernels, on their clock, as CPU ops. From those events:

  spans        the `idccrn.*` CPU events on the thread that opened the
               entry spans (`ENTRIES`: one item of their path each); a
               span's parent is the innermost span containing it there
  device_s     each device op's seconds (clipped to the stretch), charged
               to the innermost span open when the CPU op that launched
               it started (or the span itself, where the span launched
               it), whatever its thread: autograd's backward thread
               launches inside `idccrn.train.backward`. A launch outside
               every span, or a device op with no CPU op, goes to
               "(outside program)"
  idle_s       each gap between device intervals (devtrace's), split at
               span edges, each piece charged to the innermost span open
               during it, else "(outside program)"; in a marked run the
               part of a gap outside every mark is "paced wait", as
               devtrace names it
  wall_s, count  the summed wall seconds and the count of each span name
  items_s      the wall seconds of each entry span, per entry name

So device_s sums to the stretch's device time and idle_s to its wall
less its busy time.

Run one cell with its traced stretch reduced this way:

  python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

from the root of a checkout, on a CUDA card: the cell runs as
`benchmark/run.py --trace 1` runs it, and one JSON line gives the
reduction, the Enhancer's padding counters over the traced pass and the
per-layer numbers of `layer_metrics`.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import importlib
import inspect
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import compare, devtrace, flops, harness, inputs  # noqa: E402
from benchmark.reference.model import Geometry  # noqa: E402

PREFIX = "idccrn."
ENTRIES = ("idccrn.enhance.batch", "idccrn.stream.chunk", "idccrn.train.step")
OUTSIDE = "(outside program)"
PACED = "paced wait"


@dataclasses.dataclass
class SpanSummary:
    device_s: Dict[str, float]
    idle_s: Dict[str, float]
    wall_s: Dict[str, float]
    count: Dict[str, int]
    items_s: Dict[str, List[float]]

    def note(self) -> dict:
        """Idle and device seconds by span, largest first."""
        rank = lambda d: {k: round(v, 6) for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])}
        return {"idle_s": rank(self.idle_s), "device_s": rank(self.device_s)}


def _segments(spans: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """Disjoint, sorted (start, end, innermost span) pieces of nested
    spans; no piece where no span is open."""
    points = sorted({p for a, b, _ in spans for p in (a, b)})
    order = sorted(spans, key=lambda s: (s[0], -s[1]))
    segs, stack, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(order) and order[i][0] <= a:
            stack.append(order[i])
            i += 1
        stack = [s for s in stack if s[1] > a]
        if stack:
            segs.append((a, b, stack[-1][2]))
    return segs


def _charge(a: int, b: int, segs, starts, out: Dict[str, float]) -> None:
    """Seconds of (a, b) to the segments' spans, the rest outside."""
    i = max(0, bisect.bisect_right(starts, a) - 1)
    inside = 0
    while i < len(segs) and segs[i][0] < b:
        part = min(b, segs[i][1]) - max(a, segs[i][0])
        if part > 0:
            out[segs[i][2]] += part / 1e9
            inside += part
        i += 1
    if b - a > inside:
        out[OUTSIDE] += (b - a - inside) / 1e9


def _innermost(t: int, segs, starts) -> str:
    i = bisect.bisect_right(starts, t) - 1
    return segs[i][2] if i >= 0 and t < segs[i][1] else OUTSIDE


def summarize(events) -> SpanSummary:
    """Reduce raw profiler events (devtrace's) to a SpanSummary of the
    stretch."""
    from torch.autograd import DeviceType

    stretch, marks, launches, dev, named = None, [], {}, [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == devtrace.STRETCH:
                stretch = (e.start_ns(), devtrace._end_ns(e),
                           e.start_thread_id())
            elif name == devtrace.MARK:
                marks.append((e.start_ns(), devtrace._end_ns(e)))
            elif e.linked_correlation_id() == 0:
                if name.startswith(PREFIX):
                    named.append((e.start_ns(), devtrace._end_ns(e), name,
                                  e.start_thread_id()))
                if e.correlation_id() > 0:
                    launches[e.correlation_id()] = e.start_ns()
        elif name not in (devtrace.STRETCH, devtrace.MARK):
            dev.append((e.start_ns(), devtrace._end_ns(e),
                        e.linked_correlation_id()))
    if stretch is None:
        raise ValueError(f"no '{devtrace.STRETCH}' annotation in the trace")
    s0, s1, thread = stretch
    entry = [s for s in named if s[2] in ENTRIES]
    if entry:
        thread = min(entry)[3]
    spans = [(max(a, s0), min(b, s1), n) for a, b, n, th in named
             if th == thread and b > s0 and a < s1]
    segs = _segments(spans)
    starts = [a for a, _, _ in segs]

    device_s: Dict[str, float] = collections.defaultdict(float)
    clipped = sorted((max(a, s0), min(b, s1), c) for a, b, c in dev
                     if b > s0 and a < s1)
    for a, b, corr in clipped:
        launch = launches.get(corr)
        where = OUTSIDE if launch is None else _innermost(launch, segs, starts)
        device_s[where] += (b - a) / 1e9

    idle_s: Dict[str, float] = collections.defaultdict(float)
    marks = devtrace._union(marks)
    prev = s0
    for a, b in devtrace._union([(a, b) for a, b, _ in clipped]) + [[s1, s1]]:
        if a > prev:
            pieces = ([(max(prev, m0), min(a, m1)) for m0, m1 in marks
                       if m1 > prev and m0 < a] if marks else [(prev, a)])
            for p0, p1 in pieces:
                _charge(p0, p1, segs, starts, idle_s)
            outside = (a - prev) - sum(p1 - p0 for p0, p1 in pieces)
            if outside > 0:
                idle_s[PACED] += outside / 1e9
        prev = max(prev, b)

    wall_s: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    items_s: Dict[str, List[float]] = collections.defaultdict(list)
    for a, b, name in sorted(spans):
        wall_s[name] += (b - a) / 1e9
        count[name] += 1
        if name in ENTRIES:
            items_s[name].append((b - a) / 1e9)
    return SpanSummary(dict(device_s), dict(idle_s), dict(wall_s),
                       dict(count), dict(items_s))


def traced(fn, device: torch.device):
    """(fn(), devtrace.Summary, SpanSummary) of one traced stretch, run
    as `devtrace.traced` runs it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(devtrace.STRETCH):
            result = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    events = prof.profiler.kineto_results.events()
    return result, devtrace.summarize(events), summarize(events)


def pass_decoder_flops(config: dict, mix: dict, seed: int,
                       bucket: int) -> float:
    """`flops.decoder_macs` x 2 x the decoders the out-type runs, over
    the buckets of one pass of the eval pool."""
    geo, fs = Geometry.of(config), config["stft"]["fs"]
    s, b = mix["num_samples"], mix["batch_size"]
    decoders = 1 if config["serve"]["outtype"] == "clean_direct" else 2
    lengths = [len(w) for w in inputs.utterance_pool(mix, seed, fs)]
    return sum(2.0 * decoders * flops.decoder_macs(geo, rows * s, rows, t)
               for rows, t in flops.bucket_frames(lengths, b,
                                                  config["stft"]["hop"],
                                                  bucket))


def layer_metrics(facts: harness.Facts, sp: SpanSummary,
                  counters: Optional[dict] = None,
                  dec_flops: Optional[float] = None) -> Dict[str, float]:
    """The per-layer numbers the spans and the counters give, by the
    name each would carry in BENCHMARK.json; a number whose span or
    counter is missing is left out."""
    t, work, out = facts.trace, facts.trace_work, {}
    wall = lambda name: sp.wall_s.get(name)
    if facts.kind == "eval_utterances":
        if wall("idccrn.lstm"):
            out["lstm_ms.enhance"] = (
                1e3 * wall("idccrn.lstm") / work["audio_s"])
            idle = t.window_s - t.busy_s
            out["idle_in_lstm.enhance"] = (
                100.0 * sp.idle_s.get("idccrn.lstm", 0.0) / idle)
        if dec_flops and sp.device_s.get("idccrn.dec"):
            out["dec_mfu.enhance"] = 100.0 * dec_flops / (
                sp.device_s["idccrn.dec"] * facts.peak_tflops * 1e12)
        if counters and counters.get("padded_frames"):
            out["pad_share.enhance"] = 100.0 * (
                counters["padded_frames"] - counters["real_frames"]) \
                / counters["padded_frames"]
    elif facts.kind == "train_step":
        for phase in ("forward", "backward", "optimizer"):
            if wall(f"idccrn.train.{phase}"):
                out[f"{phase}_ms.train"] = (
                    1e3 * wall(f"idccrn.train.{phase}") / work["steps"])
    elif facts.kind == "stream_paced":
        chunks = sp.items_s.get("idccrn.stream.chunk")
        if chunks:
            out["chunk_launch_ms.stream"] = 1e3 * statistics.median(chunks)
        if wall("idccrn.lstm"):
            out["lstm_ms.stream"] = 1e3 * wall("idccrn.lstm") / work["chunks"]
    return out


class SpanRun(harness.Run):
    """A run whose traced stretch is also reduced by span, with the
    program's counters (an Enhancer's) read around it."""

    program = spans = counters = None

    def traced(self, fn):
        before = dict(getattr(self.program, "counters", {}))
        result, summary, self.spans = traced(fn, self.device)
        after = getattr(self.program, "counters", {})
        self.counters = {k: v - before.get(k, 0) for k, v in after.items()}
        return result, summary


def report(cell: str, seed: int, seconds: float, device: torch.device,
           t0: float, root: str = harness.ROOT, config: Optional[dict] = None,
           mix: Optional[dict] = None) -> dict:
    """One run of `cell` with a traced stretch, reduced by span."""
    bench = harness.load_json(root, "BENCHMARK.json")
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    here = os.path.join(root, "benchmark")
    config = config or harness.load_json(here, "configs",
                                         f"{entry['config']}.json")
    mix = mix or harness.load_json(here, "traffic", f"{entry['traffic']}.json")
    limits = harness.load_json(here, "workloads", f"{cell}.json")["limits"]
    traffic = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    run = SpanRun(cell, config, mix, limits, seed, seconds, True, device, t0)
    build = inspect.signature(traffic.run).parameters["build"].default

    def keep(*args, **kwargs):
        run.program = build(*args, **kwargs)
        return run.program

    out = traffic.run(run, build=keep)
    t, sp = out.facts.trace, run.spans
    dec_flops = (pass_decoder_flops(config, mix, seed,
                                    run.program.bucket_frames)
                 if out.facts.kind == "eval_utterances" else None)
    return {
        "cell": cell, "seed": seed,
        "correct": out.failed == 0 and all(
            compare.within(v, lim) for v, lim in out.checks.values()),
        "e2e": out.e2e, "setup_s": run.setup_s,
        "trace": {"window_s": t.window_s, "busy_s": t.busy_s,
                  "device_s": sum(t.op_s.values()),
                  "marks_s": t.marks_s, "work": out.facts.trace_work},
        "sums": {"device_s": sum(sp.device_s.values()),
                 "idle_s": sum(sp.idle_s.values())},
        "metrics": layer_metrics(out.facts, sp, run.counters, dec_flops),
        "counters": run.counters, "dec_flops": dec_flops,
        "wall_s": sp.wall_s, "count": sp.count,
        "items_ms_p50": {k: 1e3 * statistics.median(v)
                         for k, v in sp.items_s.items()},
        "per_item": {k: sum(sp.count.values()) / len(v)
                     for k, v in sp.items_s.items()},
        **sp.note(),
        "card": harness.power_limit() if device.type == "cuda" else None,
    }


def main(argv) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description="One traced run of one cell, "
                                            "reduced by the program's spans.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(2)
    line = report(args.workload, args.seed, args.seconds,
                  torch.device("cuda", 0), t0)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
