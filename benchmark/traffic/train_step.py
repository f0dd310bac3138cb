"""CVAE pretraining steps: `PretrainTrainer.train_step`, once per step,
each on a fresh batch of `batch_size` segments of `segment_frames`
frames cut from a seeded host pool (the trainer copies it in) and with
latent draws made by the benchmark (`noise=`).

Mix keys: "batch_size", "num_samples", "segment_frames",
"pool_utterances", "pool_seconds", "check_steps".

End to end: `train_segments_per_s`, the segments of every completed step
over the window's wall seconds.

Set-up builds the trainer once and drives it through its first
`check_steps` steps on the window's own call and feed; the same object
then runs the window. The reference follows those steps from the same
weights, batches and draws. Compared, each by its worst item:
  loss1_gap    the first step's loss, term by term (complex MSE,
               magnitude MSE, KL), against the reference's, relative.
               The later steps' losses are left out: after one Adam step
               every element has moved by about the learning rate in
               the direction of its gradient's sign, which rounding
               flips for the elements whose gradient is near nought, so
               their losses part by the noise of the update (up to
               4e-4 where the first step's part by 2e-6)
  grad_gap     per leaf, the norm of the first step's gradient as Adam
               took it (its first moment after the step over 1 - beta1)
               against the reference's, over max(the reference leaf's
               norm, the median leaf's)
  change_gap   per leaf, the norm of the parameters' change over the
               steps, likewise; leaves whose reference loss gradient is
               under a thousandth of the median leaf's (a conv bias under
               batch norm) move by round-off alone and are left out

Sides for `benchmark/calibrate.py` (`SIDES`, the control `CONTROL`
first): the trainer at bf16; a fault, each step on half of its batch
and draws, the loss's mean taken over the rest (a state left unchanged
reads 1 and needs no run).
"""

from __future__ import annotations

import functools
import statistics
import traceback

import torch

from benchmark import compare, flops, inputs, programs
from benchmark.harness import Facts, Outcome, Run, peak_for
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train


class Feed:
    """Step k's batch (host) and draws (device), from the seed."""

    def __init__(self, run: Run, zdim: int):
        mix, fs = run.mix, run.config["stft"]["fs"]
        self.seed, self.device, self.mix = run.seed, run.device, mix
        self.length = (mix["segment_frames"] - 1) * run.config["stft"]["hop"]
        self.pool = inputs.segment_pool(mix, run.seed, fs)
        self.shape = (mix["batch_size"], mix["num_samples"],
                      mix["segment_frames"], zdim)

    def batch(self, k: int):
        cuts = inputs.segment_cuts(self.pool, self.mix["batch_size"],
                                   self.length, self.seed, k)
        return inputs.cut(self.pool, cuts, self.length)

    def draws(self, k: int):
        return inputs.latent_draws(self.shape, self.seed, k, self.device)


def leaf_norms(tensors: dict) -> dict:
    return {k: float(v.float().norm()) for k, v in tensors.items()}


def named_parameters(trainer) -> dict:
    out = {f"enc.{k}": p for k, p in trainer.encoder.named_parameters()}
    out.update({f"dec.{k}": p for k, p in trainer.decoder.named_parameters()})
    return out


def first_moment(trainer) -> dict:
    """Adam's first moment of each leaf (zeros before any step)."""
    state = {**trainer.opt_en.state, **trainer.opt_de.state}
    return {k: state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            for k, p in named_parameters(trainer).items()}


def program_readings(trainer, feed: Feed, steps: int, weights) -> dict:
    """The first `steps` steps of `trainer`: per-step losses, per-leaf
    norms of the first gradient (from Adam's state) and of the change."""
    beta1 = trainer.opt_en.param_groups[0]["betas"][0]
    losses, terms = [], []
    for k in range(steps):
        m = trainer.train_step(feed.batch(k), None, 0, noise=feed.draws(k))
        losses.append(float(m["total"]))
        terms.append({t: float(m[t]) for t in ("cpx", "mag", "kl")})
        if k == 0:
            grad = {n: v / (1 - beta1) for n, v in first_moment(trainer).items()}
            grad = leaf_norms(grad)
    w0 = {f"enc.{k}": v for k, v in weights[0].items()}
    w0.update({f"dec.{k}": v for k, v in weights[1].items()})
    change = {n: float((p.detach() - w0[n]).norm())
              for n, p in named_parameters(trainer).items()}
    return {"loss": losses, "terms": terms, "grad": grad, "change": change}


def reference_readings(weights, feed: Feed, steps: int, config: dict,
                       precision: ref.Precision = ref.F32) -> dict:
    t = config["train"]
    recipe = ref_train.Recipe(feed.mix["num_samples"], t["kl_weight"],
                              tuple(t["recon_loss_weight"]), t["lr"],
                              t["weight_decay"])
    batches = [torch.from_numpy(feed.batch(k)).to(feed.device)
               for k in range(steps)]
    with ref.exact_float32():
        out = ref_train.follow(weights[0], weights[1], batches,
                               [feed.draws(k) for k in range(steps)],
                               ref.Geometry.of(config), recipe, precision)
    w0 = {f"enc.{k}": v for k, v in weights[0].items()}
    w0.update({f"dec.{k}": v for k, v in weights[1].items()})
    return {"loss": out["loss"], "terms": out["terms"],
            "grad": leaf_norms(out["grad1"]),
            "grad_loss": leaf_norms(out["grad1_loss"]),
            "change": {n: float((p - w0[n]).norm())
                       for n, p in out["params"].items()}}


def gaps(got: dict, want: dict):
    """(the compared numbers, notes on them)."""
    moved = compare.moved_leaves(want["grad_loss"])
    change = ({k: got["change"][k] for k in moved},
              {k: want["change"][k] for k in moved})
    checks = {"loss1_gap": compare.relative_gaps(
                  got["terms"][0].values(),
                  [want["terms"][0][t] for t in got["terms"][0]]),
              "grad_gap": compare.norm_gap(got["grad"], want["grad"]),
              "change_gap": compare.norm_gap(*change)}
    def worst_leaf(a, b):
        med = statistics.median(b.values())
        return max(b, key=lambda k: abs(a[k] - b[k]) / max(b[k], med))
    notes = {"loss_gap_per_step": [abs(a - b) / abs(b) for a, b in
                                   zip(got["loss"], want["loss"])],
             "term_gaps_step1": {t: abs(got["terms"][0][t] - v) / abs(v)
                                 for t, v in want["terms"][0].items()},
             "grad_worst_leaf": worst_leaf(got["grad"], want["grad"]),
             "change_worst_leaf": worst_leaf(*change),
             "leaves_left_out": len(set(want["change"]) - moved)}
    return checks, notes


def run(run: Run, build=programs.trainer) -> Outcome:
    config, mix, dev = run.config, run.mix, run.device
    b, s = mix["batch_size"], mix["num_samples"]
    weights = inputs.make_weights(programs.layouts(config, "train"),
                                  run.seed, dev)
    trainer = build(config, weights, s, dev)
    feed = Feed(run, config["model"]["zdim"])
    steps = mix["check_steps"]
    got = program_readings(trainer, feed, steps, weights)

    run.open_window()
    losses, k = [], steps
    while not losses or run.elapsed() < run.seconds:
        try:
            m = trainer.train_step(feed.batch(k), None, 0,
                                   noise=feed.draws(k))
            losses.append(m["total"])
        except Exception:
            traceback.print_exc()
            losses.append(torch.tensor(float("nan")))
        k += 1
    run.close_window()
    failed = sum(not torch.isfinite(v).item() for v in losses)
    n = len(losses)
    step_flops = flops.train_step_flops(config, b, mix["segment_frames"], s)
    facts = Facts(kind="train_step", work={"steps": n}, window_s=run.window_s,
                  flops=n * step_flops,
                  peak_tflops=peak_for(config["train"]["compute"]),
                  window_peak_bytes=run.window_peak)
    if run.trace:
        def two():
            for j in range(2):
                trainer.train_step(feed.batch(k + j), None, 0,
                                   noise=feed.draws(k + j))
        _, facts.trace = run.traced(two)
        facts.trace_work = {"steps": 2}

    del trainer
    run.free()
    want = reference_readings(weights, feed, steps, config)
    values, notes = gaps(got, want)
    checks = {name: (value, run.limits[name]) for name, value in values.items()}
    return Outcome(e2e={"train_segments_per_s": n * b / run.window_s},
                   attempted=n, failed=failed, checks=checks, facts=facts,
                   notes=notes)


class HalfBatch:
    """A trainer whose steps see half of their batch and draws."""

    def __init__(self, trainer):
        self.inner = trainer

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def train_step(self, batch, generator, epoch, noise=None):
        h = len(batch) // 2
        return self.inner.train_step(batch[:h], generator, epoch,
                                     noise=tuple(e[:h] for e in noise))


CONTROL = "bf16"
SIDES = {
    "bf16": lambda r: run(r, build=functools.partial(programs.trainer,
                                                     compute="bf16")),
    "half_batch": lambda r: run(r, build=lambda *a, **k: HalfBatch(
        programs.trainer(*a, **k))),
}
