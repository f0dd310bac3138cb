"""Eval-mode complex BN with the running statistics of an unconverged
model, the port against the JAX package on the CPU.

The running statistics lag the activations early in training: a
channel's mean sits far from zero against its spread, the variances
span decades across channels, and real and imaginary parts correlate.
The two eval-mode BNs are the same affine map written two ways: JAX
centres first, ``z (x - mean) + beta``; the port folds the mean into the
offset once, ``z x + (beta - z mean)``. The two agree in exact
arithmetic; in float32 ``z x`` and ``z mean`` cancel where the mean is
large against the spread. Here the statistics have

  * per-channel means of 3-30 times the spread sqrt(V),
  * Vrr and Vii spread over 1e-3 ... 1e2 (log-uniform),
  * |Vri| up to 0.9 sqrt(Vrr Vii),
  * step counters > 0,

and the activations sit around the running means (the cancelling case).

Cases:
  * `complex_batch_norm` (eval) against JAX's `complex_batch_norm(...,
    train=False)`, from one numpy draw of parameters, statistics and
    input, C = 4 and 64;
  * one CVAE `PretrainTrainer.eval_step` against JAX's, tiny geometry,
    the same latent draws. Every stage's conv output channels are
    rescaled and shifted (weights and bias) so that the batch's
    pre-BN statistics take the values above; a train-mode forward would
    whiten that away, so training would not see the change, but eval
    mode whitens with running statistics set near those values (means
    within one spread, variances within a factor 2).

Bounds:
  * f32: max |port - jax| <= 1e-4 * max |jax| for the op, each metric
    within F32_TOL (1e-4 relative) for the step.
  * bf16, the op: both sides compute the same float32 value up to a few
    float32 roundings (the fold adds one product and one sum in
    float32) and round it to bf16 once, so an element differs by at most
    one bf16 step (2**-8 relative) where the two float32 values straddle
    a rounding boundary: max |port - jax| <= 2**-8 * max |jax|.
  * bf16, the step: the forward's share of test_torch_port_bf16_steps's
    bound, each metric within BF16_REL (2%) relative. Where a conv
    output differs by one bf16 step between the two frameworks, eval
    mode whitening scales that step by |mean| / sqrt(V), up to 33 here;
    the metrics are means over many elements, in which few differ.
    Folding a bf16 mean into the offset would move every element of a
    channel by up to 30 * 2**-9 of its spread and fails this bound.

Each case prints its margin (`pytest -rP`): the error over the bound.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.ops.batchnorm import complex_batch_norm
from idccrn_vae_tpu.ops.batchnorm import complex_batch_norm as jax_bn
from torch_port_util import (
    BF16_REL,
    F32_TOL,
    NoiseStream,
    np_vars,
    patch_jax_noise,
    patch_port_noise,
    pretrain_pair,
    train_wav,
)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
OP_REL = {"f32": 1e-4, "bf16": 2.0 ** -8}
STEP_TOL = {"f32": F32_TOL, "bf16": dict(atol=1e-6, rtol=BF16_REL)}
MEAN_OVER_SPREAD = (3.0, 30.0)
LOG10_V = (-3.0, 2.0)
MAX_CORR = 0.9


def _signed(rng, c):
    return rng.choice([-1.0, 1.0], c) * rng.uniform(*MEAN_OVER_SPREAD, c)


def unconverged_stats(rng, c):
    """Running statistics (float64) with the properties above."""
    vrr = 10.0 ** rng.uniform(*LOG10_V, c)
    vii = 10.0 ** rng.uniform(*LOG10_V, c)
    rho = rng.uniform(-MAX_CORR, MAX_CORR, c)
    return {"mean_r": _signed(rng, c) * np.sqrt(vrr),
            "mean_i": _signed(rng, c) * np.sqrt(vii),
            "Vrr": vrr, "Vii": vii, "Vri": rho * np.sqrt(vrr * vii)}


def _print_margin(**fields):
    print(json.dumps({k: float(f"{v:.4g}") for k, v in fields.items()}))


@pytest.mark.parametrize("channels", [4, 64])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_eval_bn_matches_jax_with_unconverged_stats(compute, channels):
    rng = np.random.default_rng(channels)
    c = channels
    st = unconverged_stats(rng, c)
    params = {"gamma_rr": rng.normal(1.0, 0.3, c),
              "gamma_ri": rng.normal(0.0, 1.0, c),
              "gamma_ii": rng.normal(1.0, 0.3, c),
              "beta_r": rng.normal(0.0, 1.0, c),
              "beta_i": rng.normal(0.0, 1.0, c)}
    # activations around the running means: a spread within a factor
    # ~3 of sqrt(V), with the statistics' correlation
    scale = 10.0 ** rng.uniform(-0.5, 0.5, c)
    z = rng.standard_normal((2, 9, 11, 2, c))
    rho = st["Vri"] / np.sqrt(st["Vrr"] * st["Vii"])
    re = st["mean_r"] + np.sqrt(st["Vrr"] * scale) * z[..., 0, :]
    im = st["mean_i"] + np.sqrt(st["Vii"] * scale) * (
        rho * z[..., 0, :] + np.sqrt(1.0 - rho ** 2) * z[..., 1, :])
    f32 = lambda d: {k: np.asarray(v, np.float32) for k, v in d.items()}
    params, st = f32(params), f32(st)
    jdt, tdt = DTYPES[compute]
    x = jnp.asarray(np.concatenate([re, im], -1), jnp.float32).astype(jdt)
    want, _ = jax_bn(x, {k: jnp.asarray(v) for k, v in params.items()},
                     {k: jnp.asarray(v) for k, v in
                      dict(st, count=np.int32(7)).items()}, train=False)
    got = complex_batch_norm(
        torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdt),
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in st.items()})
    assert got.dtype == tdt
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got).all()
    err, top = np.abs(got - want).max(), np.abs(want).max()
    _print_margin(err_over_max=err / top, bound=OP_REL[compute],
                  margin=err / top / OP_REL[compute])
    assert err <= OP_REL[compute] * top, (err, top)


def unconverged_state(rng, jtr, state, wav):
    """`state` with every stage's conv output rescaled and shifted and
    its running statistics set as the module docstring says. The batch
    statistics of `wav` under `state`'s weights come from one JAX train
    step: with the step counters at 0 its new running statistics are
    the batch's (the step's update of the weights is discarded)."""
    stepped, _ = jtr.train_step(state, wav, jax.random.PRNGKey(0), 1)
    new = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), state)
    for model, stack in (("enc", "encoder"), ("dec", "decoder")):
        for i, batch in enumerate(stepped[model]["stats"][stack]):
            batch = {k: np.asarray(v, np.float64) for k, v in batch.items()}
            conv = new[model]["params"][stack][i]["conv"]
            c = batch["Vrr"].shape[0]
            s = np.sqrt(10.0 ** rng.uniform(*LOG10_V, c) / batch["Vrr"])
            vrr, vii = batch["Vrr"] * s * s, batch["Vii"] * s * s
            dr = _signed(rng, c) * np.sqrt(vrr)
            di = _signed(rng, c) * np.sqrt(vii)
            # out_re += dr, out_im += di: the effective bias is
            # (br - bi, br + bi)
            for k in ("wr", "wi", "br", "bi"):
                conv[k] = (conv[k] * s).astype(np.float32)
            conv["br"] = (conv["br"] + (dr + di) / 2).astype(np.float32)
            conv["bi"] = (conv["bi"] + (di - dr) / 2).astype(np.float32)
            lag = lambda: 2.0 ** rng.uniform(-1.0, 1.0, c)
            run_rr, run_ii = vrr * lag(), vii * lag()
            rho = rng.uniform(-MAX_CORR, MAX_CORR, c)
            stats = {"mean_r": batch["mean_r"] * s + dr
                     + rng.uniform(-1, 1, c) * np.sqrt(vrr),
                     "mean_i": batch["mean_i"] * s + di
                     + rng.uniform(-1, 1, c) * np.sqrt(vii),
                     "Vrr": run_rr, "Vii": run_ii,
                     "Vri": rho * np.sqrt(run_rr * run_ii)}
            stats = {k: v.astype(np.float32) for k, v in stats.items()}
            stats["count"] = np.asarray(rng.integers(1, 50), np.int32)
            new[model]["stats"][stack][i] = stats
    return jax.tree_util.tree_map(jnp.asarray, new)


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_cvae_eval_step_matches_jax_with_unconverged_stats(monkeypatch,
                                                           compute):
    jtr, state, ttr = pretrain_pair(monkeypatch, skip_mode="zero",
                                    compute=compute)
    wav = train_wav(1)
    patch_jax_noise(monkeypatch, NoiseStream(3),
                    module="idccrn_vae_tpu.models.vae")
    state = unconverged_state(np.random.default_rng(7), jtr, state, wav)
    means = [np.abs(np.asarray(s["mean_r"])) / np.sqrt(np.asarray(s["Vrr"]))
             for m, k in (("enc", "encoder"), ("dec", "decoder"))
             for s in state[m]["stats"][k]]
    assert max(float(r.max()) for r in means) > 10.0
    load_jax_variables(ttr.encoder, np_vars(state["enc"]))
    load_jax_variables(ttr.decoder, np_vars(state["dec"]))
    patch_jax_noise(monkeypatch, NoiseStream(4),
                    module="idccrn_vae_tpu.models.vae")
    patch_port_noise(monkeypatch, NoiseStream(4),
                     module="idccrn_vae_torch.models.vae")
    want = jtr.eval_step(state, wav, jax.random.PRNGKey(1), 0)
    got = ttr.eval_step(wav, None, 0)
    assert set(got) == set(want)
    tol = STEP_TOL[compute]
    worst = 0.0
    for k in want:
        w, g = float(want[k]), float(got[k])
        assert np.isfinite(g), k
        worst = max(worst, abs(g - w) / (tol["atol"] + tol["rtol"] * abs(w)))
        np.testing.assert_allclose(g, w, err_msg=k, **tol)
    _print_margin(worst_over_bound=worst, total_jax=float(want["total"]))
