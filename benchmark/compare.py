"""The numbers that decide `correct`, and how each is printed beside its
limit.

Every gap is a distance measured against a scale that no single small
item can shrink: an item's own size or the median item's, whichever is
larger. A gradient that is nought to rounding, as a conv bias's under
batch norm, or an answer that is all but silent, then reads by the
typical item's scale instead of by its own.
"""

from __future__ import annotations

import math
import statistics
import sys
from typing import Dict, Iterable, Sequence

import numpy as np


def worst_gap(pairs: Sequence[tuple]) -> float:
    """pairs: (distance, reference size) per item; the largest distance
    over max(size, median size)."""
    if not pairs:
        raise ValueError("nothing to compare")
    med = statistics.median(size for _, size in pairs)
    return max(d / max(size, med) for d, size in pairs)


def array_gap(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> float:
    """Worst L2 distance of answers (waveforms), each over max(its
    reference's L2 norm, the median one); a non-finite answer reads
    infinite."""
    pairs = []
    for g, w in zip(got, want, strict=True):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise ValueError(f"answer of shape {g.shape}, want {w.shape}")
        pairs.append((float(np.linalg.norm(g - w)), float(np.linalg.norm(w))))
    d = worst_gap(pairs)
    return d if math.isfinite(d) else math.inf


def pooled_gap(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> float:
    """L2 distance of all answers together over their reference's L2
    norm; a non-finite answer reads infinite."""
    err = ref = 0.0
    for g, w in zip(got, want, strict=True):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise ValueError(f"answer of shape {g.shape}, want {w.shape}")
        err += float(np.sum((g - w) ** 2))
        ref += float(np.sum(w * w))
    d = math.sqrt(err / ref)
    return d if math.isfinite(d) else math.inf


def norm_gap(got: Dict[str, float], want: Dict[str, float]) -> float:
    """Worst gap between two sets of per-leaf norms: |a - b| over
    max(b, median b)."""
    if sorted(got) != sorted(want):
        raise ValueError("leaf sets differ")
    return worst_gap([(abs(got[k] - want[k]), want[k]) for k in want])


def moved_leaves(grad_norms: Dict[str, float],
                 share: float = 1e-3) -> set:
    """Leaves whose loss gradient reaches `share` of the median leaf's:
    the rest (a conv bias under batch norm) have a gradient of round-off
    alone, which Adam turns into a step of arbitrary sign."""
    med = statistics.median(grad_norms.values())
    return {k for k, v in grad_norms.items() if v >= share * med}


def relative_gaps(got: Iterable[float], want: Iterable[float]) -> float:
    """Worst |a - b| / |b| over paired scalars (the steps' losses)."""
    return max(abs(a - b) / abs(b) for a, b in zip(got, want, strict=True))


def report(checks: Dict[str, tuple]) -> Dict[str, dict]:
    """Print each compared number beside its limit on standard error and
    return them for the result line: {name: {"value", "limit"}}."""
    out = {}
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r} "
              f"{'ok' if within(value, limit) else 'OVER'}",
              file=sys.stderr, flush=True)
        out[name] = {"value": value, "limit": limit}
    return out


def within(value: float, limit: float) -> bool:
    return math.isfinite(value) and value <= limit

