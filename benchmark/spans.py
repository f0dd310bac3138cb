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

`harness.Run.traced` profiles every traced stretch with `traced` below,
and `run_cell` hands the reduction to the per-layer readers under
`metrics/` (`Facts.spans`) and prints its `note()` as a `note spans`
line on standard error: `python3 benchmark/run.py ... --trace 1` is the
span report.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Tuple

import torch

from benchmark import devtrace

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
    """(fn(), devtrace.Summary, SpanSummary) of one traced stretch: fn
    under torch.profiler (CPU and, on a card, CUDA activities) inside
    the user annotation `devtrace.STRETCH`, closed by a synchronize, the
    profiler's raw events (`kineto_results.events()`) reduced twice,
    without torch's slower tree of FunctionEvents."""
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

