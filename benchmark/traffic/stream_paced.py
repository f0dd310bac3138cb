"""Real-time streaming, an open loop: one stream of `chunk_frames`-frame
chunks through `StreamingEnhancer.process_chunk`, chunk k due at the
window's start plus k chunk durations (the audio's own rate), sent when
due or, if the previous chunk ran late, as soon as it returns. A chunk's
latency runs from its due time to its enhanced samples on the host, so
a stall counts against every chunk queued behind it. The window is
`--seconds` of audio.

Mix keys: "chunk_frames", "warm_chunks".

End to end: `chunk_ms_p95`, the 95th percentile of the window's chunk
latencies. Set-up builds the streamer and runs `warm_chunks` chunks of a
separate stream; the window's stream starts from a fresh state.

The sender waits for each due time by polling the clock, not by
sleeping, so that the chunk starts on a running core and not after the
scheduler's wake-up; the objects left by set-up are frozen out of the
garbage collector for the window (`gc.freeze`), so that a full
collection does not walk the imported modules in the middle of a chunk.

Check: the window's whole output against the plain reference's causal
enhancement of the same audio with a stream's framing (z = mu):
`chunk_gap`, the worst chunk's L2 distance over its reference's norm (or
the median chunk's, if larger). The first n_fft - hop output samples
belong to the zeros before the stream and are not compared.

Side for `benchmark/calibrate.py` (`SIDES`; the control `CONTROL`): the
plain reference with bf16 operands in the program's place, against the
reference at float32, on the audio of a run.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
import traceback

import numpy as np
import torch

from benchmark import compare, devtrace, inputs, programs
from benchmark.harness import Facts, Outcome, Run
from benchmark.reference import model as ref


def chunk_gap(out: np.ndarray, want: np.ndarray, chunk: int,
              lead: int) -> float:
    """Worst chunk of the output from sample `lead` on."""
    length = out.shape[-1]
    edges = [lead] + [c for c in range(chunk, length, chunk) if c > lead]
    edges.append(length)
    return compare.array_gap([out[..., a:b] for a, b in zip(edges, edges[1:])],
                             [want[..., a:b] for a, b in zip(edges, edges[1:])])


def wait_until(due: float) -> None:
    """Poll the clock until `due` (perf_counter seconds)."""
    while time.perf_counter() < due:
        pass


def reference_stream(audio: np.ndarray, weights, config: dict, device,
                     precision: ref.Precision = ref.F32) -> np.ndarray:
    with torch.no_grad(), ref.exact_float32():
        out = ref.stream_enhance(torch.from_numpy(audio).to(device), weights,
                                 ref.Geometry.of(config), precision)
    return out.cpu().numpy()


def run(run: Run, build=programs.streamer) -> Outcome:
    config, mix, dev = run.config, run.mix, run.device
    fs, hop = config["stft"]["fs"], config["stft"]["hop"]
    m = mix["chunk_frames"] * hop
    period = m / fs
    n = max(1, round(run.seconds / period))
    weights = inputs.make_weights(programs.layouts(config, "stream"),
                                  run.seed, dev)
    st = build(config, weights, mix["chunk_frames"], dev)
    audio = inputs.stream_audio(n * period, run.seed, fs)
    warm = inputs.stream_audio(mix["warm_chunks"] * period,
                               inputs.subseed(run.seed, "warm"), fs)
    state = st.init_state(1)
    for k in range(mix["warm_chunks"]):
        out, state = st.process_chunk(state, warm[:, k * m:(k + 1) * m])
        out.cpu()

    gc.collect()
    gc.freeze()
    run.open_window()
    state = st.init_state(1)
    outs, lat, late, failed = [], [], [], 0
    t0 = time.perf_counter()
    for k in range(n):
        due = t0 + k * period
        wait_until(due)
        start = time.perf_counter()
        late.append(start - due)
        try:
            out, state = st.process_chunk(state, audio[:, k * m:(k + 1) * m])
            host = out.cpu().numpy()
        except Exception:
            traceback.print_exc()
            host = np.full((1, m), np.nan, np.float32)
        lat.append(time.perf_counter() - due)
        failed += not np.isfinite(host).all()
        outs.append(host)
    run.close_window()
    gc.unfreeze()
    lat_ms = [1e3 * v for v in lat]
    facts = Facts(kind="stream_paced", work={"chunks": n},
                  window_s=run.window_s, latencies_ms=lat_ms,
                  window_peak_bytes=run.window_peak)
    if run.trace:
        traced_n = max(1, min(n, round(2.0 / period)))

        def paced():
            s, t1 = st.init_state(1), time.perf_counter()
            for k in range(traced_n):
                wait_until(t1 + k * period)
                with devtrace.mark():
                    o, s = st.process_chunk(s, audio[:, k * m:(k + 1) * m])
                    o.cpu()
        _, facts.trace = run.traced(paced)
        facts.trace_work = {"chunks": traced_n}

    del st
    run.free()
    want = reference_stream(audio, weights, config, dev)
    got = np.concatenate(outs, axis=-1)
    gap = (chunk_gap(got, want, m, config["stft"]["n_fft"] - hop)
           if np.isfinite(got).all() else math.inf)
    p95 = float(np.percentile(lat_ms, 95, method="linear"))
    return Outcome(e2e={"chunk_ms_p95": p95}, attempted=n, failed=failed,
                   checks={"chunk_gap": (gap, run.limits["chunk_gap"])},
                   facts=facts, notes={
                       "late_ms_median": 1e3 * statistics.median(late),
                       "late_ms_max": 1e3 * max(late),
                       "latency_ms_p50_p99_max": [
                           float(np.percentile(lat_ms, q)) for q in
                           (50, 99, 100)]})


def reference_bf16(run: Run) -> Outcome:
    """The control's chunk_gap on the audio of `run`; no window."""
    config, mix, dev = run.config, run.mix, run.device
    hop = config["stft"]["hop"]
    m = mix["chunk_frames"] * hop
    period = m / config["stft"]["fs"]
    n = max(1, round(run.seconds / period))
    weights = inputs.make_weights(programs.layouts(config, "stream"),
                                  run.seed, dev)
    audio = inputs.stream_audio(n * period, run.seed, config["stft"]["fs"])
    want = reference_stream(audio, weights, config, dev)
    got = reference_stream(audio, weights, config, dev, ref.BF16)
    gap = chunk_gap(got, want, m, config["stft"]["n_fft"] - hop)
    return Outcome(e2e={}, attempted=n, failed=0,
                   checks={"chunk_gap": (gap, run.limits["chunk_gap"])},
                   facts=Facts(kind="stream_paced"))


CONTROL = "bf16"
SIDES = {"bf16": reference_bf16}
