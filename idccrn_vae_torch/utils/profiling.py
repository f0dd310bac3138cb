"""Profiling, step timing and memory observability.

Mirrors `idccrn_vae_tpu/utils/profiling.py`:

  * `trace(log_dir)`: a context manager over `torch.profiler` that
    writes a Chrome trace (chrome://tracing, Perfetto) into `log_dir`.
  * `StepTimer`: wall time per step, waiting for the card on a probe
    value; the mean, median, p95 and total.
  * `log_memory`: the host's peak RSS and, per visible card, the bytes
    the caching allocator holds for tensors now and at its peak.

`sync`, `fetch` and `device_memory` are the waits and memory reads the
measurement tools (`idccrn_vae_torch/tools/common.py`) share with these.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

_TRACE_IDS = itertools.count()


def sync(device: torch.device) -> None:
    """Wait for every launch queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fetch(x) -> float:
    """One element of `x` on the host: waits for what produced it."""
    if isinstance(x, (tuple, list)):
        x = x[0]
    if isinstance(x, dict):
        x = next(iter(x.values()))
    return float(x.reshape(-1)[0].item())


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_until_ready(probe: Any) -> Any:
    """Wait for the cards that hold a tensor of `probe` (a tensor or
    nested dicts / lists / tuples of them); returns `probe`."""
    for device in {t.device for t in _tensors(probe)}:
        sync(device)
    return probe


def device_memory(device: torch.device) -> Tuple[int, int]:
    """(bytes in use, peak bytes in use) of tensors on a CUDA `device`,
    from the caching allocator's statistics; the peak counts from the
    process start or the last `torch.cuda.reset_peak_memory_stats`."""
    stats = torch.cuda.memory_stats(device)
    return (stats.get("allocated_bytes.all.current", 0),
            stats.get("allocated_bytes.all.peak", 0))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block and write its Chrome trace into `log_dir`:
    `with trace('/tmp/prof') as prof: step(...)`.

    CPU activity always, and CUDA activity when a card is visible. On
    exit the card is synchronised, so the trace holds every kernel the
    block launched. Yields the `torch.profiler.profile`, whose
    `key_averages()` stay readable after the block; the trace's path is
    its `trace_path` attribute.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(
        log_dir, f"trace_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}_"
                 f"{next(_TRACE_IDS)}.json")
    try:
        with prof:
            try:
                yield prof
            finally:
                if cuda:
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(prof.trace_path)


class StepTimer:
    """Per-step wall timing that waits for the card on a probe value.

    `with timer: step()` records the block's wall time;
    `timer.__enter__()` ... `timer.block_and_stop(out)` records up to
    when the card has finished `out`.
    """

    def __init__(self, name: str = "step"):
        self.name = name
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def block_and_stop(self, probe):
        """Wait for `probe`'s cards, then record (the last call of a
        manual start/stop pattern)."""
        block_until_ready(probe)
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        t = np.asarray(self.times)
        return {
            "count": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "total_s": float(t.sum()),
        }


def log_memory(logger=None) -> Dict[str, float]:
    """Host peak RSS (MB) and, per visible card i, the allocator's bytes
    in use and its peak (MB): keys `host_rss_mb`, `{i}_bytes_in_use_mb`,
    `{i}_peak_bytes_mb`, the JAX package's."""
    out: Dict[str, float] = {}
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is kilobytes on Linux but bytes on macOS
        out["host_rss_mb"] = rss / (1024.0 * 1024.0
                                    if sys.platform == "darwin" else 1024.0)
    except Exception:  # pragma: no cover
        pass
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            in_use, peak = device_memory(torch.device("cuda", i))
            out[f"{i}_bytes_in_use_mb"] = in_use / 1e6
            out[f"{i}_peak_bytes_mb"] = peak / 1e6
    if logger is not None:
        logger.info("memory: %s", {k: round(v, 1) for k, v in out.items()})
    return out
