"""Offline enhancement of long recordings by CMGAN's generator, a closed
loop as `eval_utterances`: the mix's pool of noisy utterances through
`CmganEnhancer.enhance_utterances` (length-sorted, bucketed, padded
batches of `batch_size`, buckets of `bucket_frames` STFT frames), pass
after pass until the window has run `--seconds`.

Mix keys: "pool" (as `eval_utterances`), "batch_size", "bucket_frames".

End to end: `enhance_rtfx`, the seconds of input audio of every pass over
the window's wall seconds. Set-up warms every bucket of the pool with one
pass (the attention kernel's build among them). The traced stretch is
whole passes more, as many as reach `eval_utterances.TRACE_S` seconds;
its work is their audio seconds and their attention's FLOPs and bytes
(`benchmark/cmgan_flops.py`, over real lengths), and the enhancer is the
run's program, whose padding and score counters it reads. `Facts.kind`
is "eval_utterances": the whole-program readers apply.

Checks (a run is correct when both are within the cell's limits):
  out_gap   one pass, drawn from the seed, of the window's answers
            against the plain reference (`benchmark/reference/cmgan.py`,
            float32, TF32 off, one utterance at a time, unpadded, as
            `evaluation.py`): the L2 distance of the pass's answers
            together over the reference's norm (the worst utterance's is
            printed as a note).
  attn_gap  the attention itself, which out_gap barely sees at random
            weights (the long axis's softmax is diffuse, and bf16 in the
            conv stacks makes most of out_gap): in the window's first
            pass, the side's first attention call at its largest n (the
            first TSCB's time axis at the longest bucket), 16 of its rows
            drawn from the seed, their q, k, v, key lengths and answers;
            then the reference's `attend` in float32 on the same q, k, v,
            each row's real keys and the weights' table: the rows' L2
            distance together over the reference's norm.

Sides for `benchmark/calibrate.py` (`SIDES`, the control `CONTROL`
first): the plain reference at fp8 e4m3 operands in every conv, linear
layer and attention product in the program's place (`fp8`), and the
program with every relative-position table zero, so that q . E = 0
(`no_relative`).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from benchmark import cmgan_flops, compare, inputs
from benchmark.harness import Facts, Outcome, Run, peak_for
from benchmark.reference import cmgan as ref
from benchmark.traffic.eval_utterances import one_pass, traced_passes


def widths(config: dict) -> dict:
    m = config["model"]
    if m["num_channel"] != m["heads"] * m["dim_head"]:
        raise ValueError(f"num_channel {m['num_channel']} is not heads x "
                         f"dim_head")
    return dict(num_channel=m["num_channel"], num_tscb=m["num_tscb"],
                heads=m["heads"], max_pos_emb=m["max_pos_emb"])


def reference_model(config: dict, device) -> ref.TSCNet:
    w = widths(config)
    return ref.TSCNet(w["num_channel"], config["stft"]["n_fft"] // 2 + 1,
                      w["num_tscb"], w["heads"], w["max_pos_emb"]).to(
                          device).eval()


def make_weights(config: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        layout = ref.layout(reference_model(config, "meta"))
    return inputs.make_weights([layout], seed, device)[0]


def program(config: dict, mix: dict, weights: dict, device, **override):
    from idccrn_vae_torch.eval.enhance import CmganEnhancer

    s = config["stft"]
    kw = dict(widths(config), n_fft=s["n_fft"], hop=s["hop"],
              compute=config["serve"]["compute"],
              bucket_frames=mix["bucket_frames"],
              cut_len=config["serve"]["cut_len"], device=device)
    kw.update(override)
    return CmganEnhancer(weights, **kw)


def reference_pass(pool, weights: dict, config: dict, device,
                   operand=None):
    """The plain reference's answers to `pool`, one utterance at a time,
    with `operand` (None: float32) operands."""
    model = reference_model(config, device)
    model.load_state_dict(weights)
    s = config["stft"]
    outs = []
    with torch.no_grad(), ref.exact_float32(), ref.operands(operand):
        for w in pool:
            y = ref.enhance(torch.from_numpy(w).to(device), model,
                            s["n_fft"], s["hop"], config["serve"]["cut_len"])
            outs.append(y.cpu().numpy())
    return outs


def _without_relative(weights: dict) -> dict:
    return {k: torch.zeros_like(w) if k.endswith("rel_pos_emb.weight")
            else w for k, w in weights.items()}


CAPTURE_ROWS = 16
TABLE = "TSCB_1.time_conformer.attn.fn.rel_pos_emb.weight"


class AttentionCapture:
    """Keeps one attention call of a side: the first at the largest n
    seen, `CAPTURE_ROWS` of its rows drawn from the seed: their q, k, v
    ((rows, heads, n, d)), answers (the same) and key lengths."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(inputs.subseed(seed, "attention"))
        self.got = None

    def keep(self, q, k, v, lengths, out):
        rows, _, n, _ = q.shape
        if self.got is not None and n <= self.got[0].shape[2]:
            return
        pick = self.rng.choice(rows, min(rows, CAPTURE_ROWS), replace=False)
        idx = torch.from_numpy(np.sort(pick)).to(q.device)
        lens = (torch.full((rows,), n) if lengths is None else lengths)
        self.got = tuple(t.index_select(0, idx) for t in (q, k, v, out)) \
            + (lens.to(q.device).index_select(0, idx),)


@contextlib.contextmanager
def capturing(cap: AttentionCapture):
    """`cap` keeps the attention calls of the program (`rel_attention` as
    `models/cmgan.py` calls it) and of the reference (`attend`) inside
    the block."""
    from idccrn_vae_torch.models import cmgan as port

    program_call, reference_call = port.rel_attention, ref.attend

    def kept_program(q, k, v, emb, lengths=None):
        out = program_call(q, k, v, emb, lengths)
        cap.keep(q, k, v, lengths, out)
        return out

    def kept_reference(q, k, v, emb, max_pos_emb, scale):
        out = reference_call(q, k, v, emb, max_pos_emb, scale)
        b, h, n, d = q.shape
        cap.keep(q, k, v, None, out.view(b, n, h, d).transpose(1, 2))
        return out

    port.rel_attention, ref.attend = kept_program, kept_reference
    try:
        yield cap
    finally:
        port.rel_attention, ref.attend = program_call, reference_call


def attention_gap(cap: AttentionCapture, weights: dict,
                  config: dict) -> float:
    """The kept rows' answers against the reference's `attend` in float32
    on the same q, k, v, each row's real keys and the first TSCB's
    time-axis table: L2 distance together over the reference's norm."""
    if cap.got is None:
        return math.inf
    q, k, v, out, lens = cap.got
    emb, m = weights[TABLE].float(), config["model"]["max_pos_emb"]
    err = norm = 0.0
    with torch.no_grad(), ref.exact_float32():
        for r, n in enumerate(lens.tolist()):
            want = ref.attend(*(t[r: r + 1, :, :n].float() for t in (q, k, v)),
                              emb.to(q.device), m, q.shape[-1] ** -0.5)[0]
            got = out[r, :, :n].float().transpose(0, 1).reshape(n, -1)
            err += float(((got - want) ** 2).sum())
            norm += float((want ** 2).sum())
    d = math.sqrt(err / norm)
    return d if math.isfinite(d) else math.inf


class ReferenceServer:
    """The plain reference in the program's place: `enhance_utterances`
    as the enhancer's, one utterance at a time."""

    def __init__(self, config, weights, device, operand):
        self.args = (weights, config, device, operand)

    def enhance_utterances(self, pool, batch_size, generator=None):
        return reference_pass(pool, *self.args)


def run(run: Run, build=program) -> Outcome:
    config, mix, dev = run.config, run.mix, run.device
    fs, b = config["stft"]["fs"], mix["batch_size"]
    weights = make_weights(config, run.seed, dev)
    enh = run.program = build(config, mix, weights, dev)
    pool = inputs.utterance_pool(mix, run.seed, fs)
    pass_audio = sum(len(w) for w in pool) / fs
    work = cmgan_flops.pass_work(config, [len(w) for w in pool], b)
    one_pass(enh, pool, b, None)

    cap = AttentionCapture(run.seed)
    run.open_window()
    passes, failed, times = [], 0, []
    while not passes or run.elapsed() < run.seconds:
        t = run.elapsed()
        if passes:
            outs, bad = one_pass(enh, pool, b, None)
        else:
            with capturing(cap):
                outs, bad = one_pass(enh, pool, b, None)
        times.append(run.elapsed() - t)
        passes.append(outs)
        failed += bad
    run.close_window()
    n = len(passes)
    facts = Facts(kind="eval_utterances", work={"audio_s": n * pass_audio},
                  window_s=run.window_s, flops=n * work["flops"],
                  peak_tflops=peak_for(config["serve"]["compute"]),
                  window_peak_bytes=run.window_peak)
    if run.trace:
        k, facts.trace = run.traced(lambda: traced_passes(enh, pool, b, None))
        facts.trace_work = {"audio_s": k * pass_audio,
                            "attn_flops": k * work["attn_flops"],
                            "attn_bytes": k * work["attn_bytes"]}

    k = int(np.random.default_rng(inputs.subseed(run.seed, "check"))
            .integers(n))
    outs = passes[k]
    del enh, passes
    run.program = None
    run.free()
    want = reference_pass(pool, weights, config, dev)
    gap = math.inf if outs is None else compare.pooled_gap(outs, want)
    notes = {"pass_s": times}
    if outs is not None:
        notes["worst_utterance_gap"] = compare.array_gap(outs, want)
    if cap.got is not None:
        notes["attn_rows_keys"] = cap.got[4].tolist()
    attn = attention_gap(cap, weights, config)
    cap.got = None
    return Outcome(e2e={"enhance_rtfx": n * pass_audio / run.window_s},
                   attempted=n * len(pool), failed=failed,
                   checks={"out_gap": (gap, run.limits["out_gap"]),
                           "attn_gap": (attn, run.limits["attn_gap"])},
                   facts=facts, notes=notes)


def _fp8(r: Run) -> Outcome:
    return run(r, build=lambda config, mix, weights, dev: ReferenceServer(
        config, weights, dev, torch.float8_e4m3fn))


CONTROL = "fp8"
SIDES = {"fp8": _fp8,
         "no_relative": lambda r: run(r, build=lambda config, mix, weights,
                                      dev: program(config, mix,
                                                   _without_relative(weights),
                                                   dev))}
