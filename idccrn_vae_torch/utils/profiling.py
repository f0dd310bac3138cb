"""Profiling, named spans, step timing and memory observability.

Mirrors `idccrn_vae_tpu/utils/profiling.py`, and adds the port's spans:

  * `trace(log_dir)`: a context manager over `torch.profiler` that
    writes a Chrome trace (chrome://tracing, Perfetto) into `log_dir`.
    An operator traces a run with `with profiling.trace(dir): ...`
    around the calls to look at; the trace shows the CUDA kernels under
    the program's spans, which `SPANS` names.
  * `span(name)`: a named region of the program (a `SPANS` key). While
    a profiler records, it is a record function, so the span lands in
    the same trace as the kernels and on their clock; otherwise it is
    one shared no-op context and costs a check of the profiler's flag.
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

# Every span of the program and what it covers. The entry spans
# (`idccrn.enhance.batch`, `idccrn.stream.chunk`, `idccrn.train.step`)
# are one item each of their path; a span's parent is the innermost span
# open around it on the same thread.
SPANS = {
    "idccrn.enhance.batch": "one batch of Enhancer.enhance_utterances: "
                            "enhance_batch and the copy-out",
    "idccrn.pad": "host bucketing and zero-padding of one batch",
    "idccrn.copy_in": "host -> device copy of a batch or a chunk",
    "idccrn.copy_out": "device -> host copy of a batch's answers, with "
                       "the host's wait for the card",
    "idccrn.stft": "framing and STFT",
    "idccrn.enc": "the encoder's conv / BN / PReLU stack",
    "idccrn.lstm": "the complex LSTM, every layer's whole recurrence",
    "idccrn.latent": "the latent heads and the sampling (or z = mu)",
    "idccrn.dec": "the decoder's dense layer and transposed-conv stack",
    "idccrn.istft": "reconstruction (mask or real_imag, datanorm undo) "
                    "and the inverse STFT",
    "idccrn.mask": "the sample mean and the out-type's mask",
    "idccrn.stream.chunk": "one StreamingEnhancer.process_chunk call",
    "idccrn.train.step": "one PretrainTrainer.train_step",
    "idccrn.train.forward": "a train step's forward and loss",
    "idccrn.train.backward": "a train step's backward",
    "idccrn.train.optimizer": "a train step's gradient reduction and "
                              "Adam updates",
    "idccrn.cmgan.stft": "CMGAN: level normalisation, STFT and the "
                         "power-law compression",
    "idccrn.cmgan.enc": "CMGAN: magnitude and phase, the dense encoder",
    "idccrn.cmgan.tscb": "CMGAN: one TSCB (time, then frequency "
                         "conformer, and the transposes between)",
    "idccrn.cmgan.attn": "CMGAN: one relative-position attention call, "
                         "either axis",
    "idccrn.cmgan.dec.mask": "CMGAN: the mask decoder and the masked "
                             "magnitude",
    "idccrn.cmgan.dec.complex": "CMGAN: the complex decoder and the sum "
                                "at the noisy phase",
    "idccrn.cmgan.istft": "CMGAN: decompression, inverse STFT and the "
                          "level undone",
}

_NO_SPAN = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled


def span(name: str):
    """`with span("idccrn.lstm"): ...`: the region as a record function
    while a profiler records, else a shared no-op.

    The record function is the one torch's compiled code opens around
    its graphs (`_RecordFunctionFast`): a `cpu_op` event on the thread
    that opens it. `torch.profiler.record_function` would make a user
    annotation, of which the profiler also puts a copy on the device's
    timeline, spanning the span's kernels and the gaps between them,
    so that a trace would read the card as busy through every span.
    Under torch.compile or a strict torch.export, which cannot trace that
    object, a span is the no-op too."""
    if not _profiler_on() or torch.compiler.is_compiling():
        return _NO_SPAN
    return torch._C._profiler._RecordFunctionFast(name)


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
