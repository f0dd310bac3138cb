"""A profiler trace of a stretch of the run, reduced to what the
per-layer metrics read.

`spans.traced(fn)` runs fn under torch.profiler (CPU and CUDA
activities) inside the user annotation "bench.stretch", closed by a
synchronize, and hands the profiler's raw events to `summarize` here
and to the reduction by span.

From the raw events:
  device ops   kernels, memcpys and memsets (every device-side event but
               the device copies of the annotations), each with the CPU
               op that launched it (the innermost op on the launching
               thread, joined by correlation id)
  busy         the union of the device ops' intervals inside the
               stretch, so that concurrent kernels count once
  marks        intervals of the user annotation "bench.mark" (the
               stream's chunks), and the busy time inside them
  idle gaps    each gap between device intervals, named after the CPU op
               that launched the device op ending it; in a marked run
               the part of a gap outside every mark is "paced wait"
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

STRETCH = "bench.stretch"
MARK = "bench.mark"
COPIES = ("Memcpy", "Memset")
CONV_OPS = ("convolution",)
MATMUL_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm",
              "aten::addbmm", "aten::matmul", "aten::linear", "aten::mv",
              "aten::addmv", "aten::dot", "aten::_int_mm")


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    kernels: int
    op_s: Dict[str, float]        # device seconds by launching CPU op
    kernel_s: Dict[str, float]    # device seconds by kernel name
    gap_s: Dict[str, float]       # idle seconds by what the host launched
    marks_s: float = 0.0
    busy_in_marks_s: float = 0.0

    def seconds_under(self, kind: str) -> float:
        """Device seconds of the ops of one kind: "conv" (any aten op of
        a convolution, forward or backward) or "matmul"."""
        if kind == "conv":
            return sum(v for k, v in self.op_s.items()
                       if any(c in k for c in CONV_OPS))
        return sum(v for k, v in self.op_s.items() if k in MATMUL_OPS)

    def breakdown(self, top: int = 10) -> dict:
        rank = lambda d: [[k[:120], v] for k, v in sorted(
            d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(self.kernel_s),
                "idle_gaps": rank(self.gap_s)}


def mark():
    """Context manager naming one item of a marked stretch."""
    from torch.profiler import record_function

    return record_function(MARK)


def _union(intervals: List[Tuple[int, int]]) -> List[List[int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(a: int, b: int, marks: List[Tuple[int, int]],
             starts: List[int]) -> int:
    """Length of (a, b) inside the sorted, disjoint marks."""
    total = 0
    i = max(0, bisect.bisect_right(starts, a) - 1)
    while i < len(marks) and marks[i][0] < b:
        total += max(0, min(b, marks[i][1]) - max(a, marks[i][0]))
        i += 1
    return total


def _end_ns(e) -> int:
    end = getattr(e, "end_ns", None)
    return end() if end else e.start_ns() + e.duration_ns()


def summarize(events) -> Summary:
    """Reduce raw profiler events (objects with the methods of torch's
    _KinetoEvent) to a Summary of the stretch. Only methods that every
    torch since 2.4 has are relied on: the annotations are known by
    name, kernels from copies by name."""
    from torch.autograd import DeviceType

    stretch: Optional[Tuple[int, int]] = None
    marks, ops, dev = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == STRETCH:
                stretch = (e.start_ns(), _end_ns(e))
            elif name == MARK:
                marks.append((e.start_ns(), _end_ns(e)))
            elif e.linked_correlation_id() == 0 and e.correlation_id() > 0:
                ops[e.correlation_id()] = name
        elif name not in (STRETCH, MARK):
            dev.append((e.start_ns(), _end_ns(e), not name.startswith(COPIES),
                        name, e.linked_correlation_id()))
    if stretch is None:
        raise ValueError(f"no '{STRETCH}' annotation in the trace")
    s0, s1 = stretch
    dev = [(max(a, s0), min(b, s1), k, n, c) for a, b, k, n, c in dev
           if b > s0 and a < s1]
    dev.sort()
    op_s: Dict[str, float] = collections.defaultdict(float)
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    for a, b, _, name, corr in dev:
        op_s[ops.get(corr, "(no cpu op)")] += (b - a) / 1e9
        kernel_s[name] += (b - a) / 1e9
    merged = _union([(a, b) for a, b, *_ in dev])
    busy = sum(b - a for a, b in merged)
    marks.sort()
    starts = [a for a, _ in marks]
    gap_s: Dict[str, float] = collections.defaultdict(float)
    # the op that opens each merged interval: the first device op in it
    openers, j = [], 0
    for a, b in merged:
        openers.append(ops.get(dev[j][4], "(no cpu op)"))
        while j < len(dev) and dev[j][0] <= b:
            j += 1
    prev = s0
    for (a, b), name in zip(merged + [[s1, s1]], openers + ["(stretch end)"]):
        if a > prev:
            inside = _overlap(prev, a, marks, starts) if marks else a - prev
            gap_s[name] += inside / 1e9
            if a - prev > inside:
                gap_s["paced wait"] += (a - prev - inside) / 1e9
        prev = max(prev, b)
    marks_ns = sum(b - a for a, b in marks)
    busy_marks = sum(_overlap(a, b, marks, starts) for a, b in merged)
    return Summary(window_s=(s1 - s0) / 1e9, busy_s=busy / 1e9,
                   kernels=sum(1 for d in dev if d[2]), op_s=dict(op_s),
                   kernel_s=dict(kernel_s), gap_s=dict(gap_s),
                   marks_s=marks_ns / 1e9, busy_in_marks_s=busy_marks / 1e9)
