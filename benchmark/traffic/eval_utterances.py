"""Offline evaluation of a test set, a closed loop: the mix's pool of
noisy utterances through `Enhancer.enhance_utterances` (length-sorted,
bucketed, padded batches of `batch_size`, `num_samples` latent draws
each), pass after pass until the window has run `--seconds`; the window
closes at the end of the pass that reaches it.

Mix keys: "pool" (groups of `count` utterances of `seconds` each, or of
lengths log-uniform in [min_s, max_s]), "batch_size", "num_samples".

End to end: `enhance_rtfx`, the seconds of input audio of every pass
over the window's wall seconds. Set-up warms every bucket of the pool
with one pass. The traced stretch is whole passes more, as many as
reach `TRACE_S` seconds (one, where a pass takes longer); its work is
their audio seconds and their decoders' FLOPs, and the Enhancer is the
run's program, whose padding counters it reads.

Check: one pass, drawn from the seed, of the window's answers against
the plain reference's enhancement of the same utterances, batches and
draws (the reference replays the pass's latent generator from its state
at the pass's start): `out_gap`, the L2 distance of the pass's answers
together over the reference's norm. (The worst utterance's distance is
printed as a note.)

Sides for `benchmark/calibrate.py` (`SIDES`, the control `CONTROL`
first): the program's own int8 serving path, quant_scope 'enc' and
'all'.
"""

from __future__ import annotations

import functools
import math
import time
import traceback

import numpy as np
import torch

from benchmark import compare, flops, inputs, programs
from benchmark.harness import Facts, Outcome, Run, peak_for
from benchmark.reference import model as ref

TRACE_S = 2.0  # the traced stretch's least length, in whole passes


def reference_pass(pool, weights, config: dict, mix: dict, gen_state,
                   device, bucket_frames: int,
                   precision: ref.Precision = ref.F32):
    """The plain reference's answers to one pass over `pool` whose
    latent generator started in `gen_state`."""
    geo = ref.Geometry.of(config)
    s, b = mix["num_samples"], mix["batch_size"]
    latents = config["model"]["latent_num"]
    gen = torch.Generator(device=device)
    gen.set_state(gen_state)
    order = np.argsort([len(w) for w in pool], kind="stable")
    outs = [None] * len(pool)
    with torch.no_grad(), ref.exact_float32():
        for i in range(0, len(order), b):
            chunk = order[i: i + b]
            frames = max(len(pool[j]) for j in chunk) // geo.hop + 1
            frames = -(-frames // bucket_frames) * bucket_frames
            batch = np.zeros((len(chunk), frames * geo.hop), np.float32)
            for r, j in enumerate(chunk):
                batch[r, : len(pool[j])] = pool[j]
            t = frames + 1
            draws = [tuple(torch.randn((len(chunk), s, t, geo.zdim),
                                       generator=gen, device=device)
                           for _ in range(2)) for _ in range(latents)]
            y = ref.enhance(torch.from_numpy(batch).to(device), weights, geo,
                            s, config["serve"]["outtype"], draws, precision)
            y = y.cpu().numpy()
            for r, j in enumerate(chunk):
                outs[j] = y[r, : len(pool[j])]
    return outs


def one_pass(enh, pool, batch: int, gen):
    """(answers or None, utterances failed) of one pass."""
    try:
        outs = enh.enhance_utterances(pool, batch, generator=gen)
    except Exception:
        traceback.print_exc()
        return None, len(pool)
    return outs, sum(not np.isfinite(o).all() for o in outs)


def traced_passes(enh, pool, batch: int, gen) -> int:
    """Whole passes until `TRACE_S` seconds have gone; their count."""
    t0, k = time.perf_counter(), 0
    while not k or time.perf_counter() - t0 < TRACE_S:
        one_pass(enh, pool, batch, gen)
        k += 1
    return k


def run(run: Run, build=programs.enhancer) -> Outcome:
    config, mix, dev = run.config, run.mix, run.device
    fs, hop = config["stft"]["fs"], config["stft"]["hop"]
    s, b = mix["num_samples"], mix["batch_size"]
    weights = inputs.make_weights(programs.layouts(config, "serve"),
                                  run.seed, dev)
    enh = run.program = build(config, weights, s, dev)
    pool = inputs.utterance_pool(mix, run.seed, fs)
    pass_audio = sum(len(w) for w in pool) / fs
    buckets = flops.bucket_frames([len(w) for w in pool], b, hop,
                                  enh.bucket_frames)
    pass_flops = sum(flops.serve_flops(config, rows, t, s)
                     for rows, t in buckets)
    gen = torch.Generator(device=dev).manual_seed(
        inputs.subseed(run.seed, "enhance"))
    one_pass(enh, pool, b, torch.Generator(device=dev).manual_seed(0))

    run.open_window()
    passes, failed, times = [], 0, []
    while not passes or run.elapsed() < run.seconds:
        state = gen.get_state()
        t = run.elapsed()
        outs, bad = one_pass(enh, pool, b, gen)
        times.append(run.elapsed() - t)
        passes.append((state, outs))
        failed += bad
    run.close_window()
    n = len(passes)
    facts = Facts(kind="eval_utterances", work={"audio_s": n * pass_audio},
                  window_s=run.window_s, flops=n * pass_flops,
                  peak_tflops=peak_for(config["serve"]["compute"]),
                  window_peak_bytes=run.window_peak)
    if run.trace:
        k, facts.trace = run.traced(
            lambda: traced_passes(enh, pool, b, gen))
        facts.trace_work = {"audio_s": k * pass_audio, "dec_flops": k * sum(
            flops.serve_decoder_flops(config, rows, t, s)
            for rows, t in buckets)}

    k = int(np.random.default_rng(inputs.subseed(run.seed, "check"))
            .integers(n))
    state, outs = passes[k]
    bucket = enh.bucket_frames
    del enh, passes
    run.program = None
    run.free()
    want = reference_pass(pool, weights, config, mix, state, dev, bucket)
    gap = math.inf if outs is None else compare.pooled_gap(outs, want)
    notes = {"pass_s": times}
    if outs is not None:
        notes["worst_utterance_gap"] = compare.array_gap(outs, want)
    return Outcome(e2e={"enhance_rtfx": n * pass_audio / run.window_s},
                   attempted=n * len(pool), failed=failed,
                   checks={"out_gap": (gap, run.limits["out_gap"])},
                   facts=facts, notes=notes)


def _int8(scope: str):
    def side(r: Run) -> Outcome:
        return run(r, build=functools.partial(
            programs.enhancer, compute="int8", quant_scope=scope))
    return side


CONTROL = "int8_enc"
SIDES = {"int8_enc": _int8("enc"), "int8_all": _int8("all")}
