"""The port at the reference geometry against the JAX package on the CPU.

DccrnConfig()'s widths (channels 1-32-64-128-128-256-256, zdim 128, LSTM
hidden 128) and the default STFT (257 bins), one seed, B=2 segments of
4000 samples (41 frames), built with torch_port_util's helpers at
`geometry="reference"` through port_tools/fullwidth_parity.py, which runs
the same cases, the other trainers and serving programs, over seeds:

  * the CVAE step (skip_mode zero, SGD) at f32 against JAX's: losses at
    F32_TOL, BN statistics at F32_TOL, counters equal, and each
    parameter's update within GRAD_TOL's rtol in relative L2, a PReLU
    slope's scaled by its sum's conditioning (`check_models_l2`,
    `f32_param_bound`);
  * the CVAE and NSVAE steps at bf16 under the yardstick of
    torch_port_util (port bf16 and JAX bf16 each measured from JAX f32);
  * `Enhancer` clean_direct at f32 (F32_TOL) and bf16 (the yardstick);
  * the yardstick's teeth: deliberately wrong port bf16 NSVAE steps fail
    it (the PReLU slopes' gradients dropped; every train-mode BN's batch
    means held constant in the backward). A third wrong step, the batch
    means rounded to bf16 before centring, moves no distance past its
    bound: at init |mean| is about the channel's spread, so that rounding
    is no larger than bf16's own rounding of the activations.

Why the f32 updates are held in relative L2 and not element by element:
the updates here are large (up to ~0.2 at lr 1e-2) and every element
passes through 12 train-mode BN backwards whose batch-mean subtractions
cancel. JAX's jitted step and the same step run op by op
(`jax.disable_jit`, another summation order) differ element by element
by up to 94 times GRAD_TOL's atol + rtol |ref|, while each parameter's
relative L2 stays at 6.5e-4; the port lies 1.2e-4 from the op-by-op step
(FULLWIDTH_PARITY_TORCH.json, `jax_eager`). Element by element GRAD_TOL,
calibrated at the tiny geometry, asks JAX for more than its own f32
reproducibility here; GRAD_TOL's rtol as a relative L2 keeps its size.

Each test prints its margins (`pytest -rP`). Alone on one worker the file
takes about 130 s on 4 cores, most of it JAX's compiles (two train steps
per trainer, two forwards) in the fixtures.
"""

import json

import pytest

import torch_port_util as U
from port_tools.fullwidth_parity import ServeCase, TrainCase
from torch_port_util import (
    check_metrics,
    check_models_l2,
    check_yardstick,
    f32_slope_prelu,
    state_at,
    yardstick,
)

B, N, SEED = 2, 4000, 0


@pytest.fixture(scope="module")
def mp():
    with pytest.MonkeyPatch.context() as m:
        m.setattr("idccrn_vae_tpu.models.modules.prelu", f32_slope_prelu())
        yield m


def _steps(mp, name):
    draws = U.SeededDraws()
    case = TrainCase(U, mp, draws, name, B, N)
    draws.install(mp)
    return case, case.steps(SEED)


@pytest.fixture(scope="module")
def cvae(mp):
    return _steps(mp, "pretrain_zero")


@pytest.fixture(scope="module")
def nsvae(mp):
    return _steps(mp, "nsvae")


def _print(what, margins):
    print(json.dumps({what: {k: float(f"{v:.4g}")
                             for k, v in margins.items()}}))


def test_fullwidth_cvae_f32_step_matches_jax(cvae):
    case, res = cvae
    (s32, l32), (before, p32, _) = res["j32"], res["p32"]
    check_metrics(p32, l32)
    assert case.trained(res) == ["enc", "dec"]
    worst = {}
    for name, path in case.paths.items():
        module, after = case.t32.models[name], state_at(s32, path)
        want = U.jax_update(module, before[name], after)
        kappa = {k: U.slope_kappa(res["slope_terms"], f"{name}.{k}", d)
                 for k, d in want.items()
                 if f"{name}.{k}" in res["slope_terms"]}
        rel = check_models_l2(module, before[name], after, f"cvae {name}",
                              kappa=kappa)
        worst[name] = max(rel.values())
    _print("cvae_f32_worst_param_of_bound", worst)


@pytest.mark.parametrize("which", ["cvae", "nsvae"])
def test_fullwidth_bf16_step_meets_the_yardstick(which, request):
    case, res = request.getfixturevalue(which)
    sides = case.sides(res)
    margins = check_yardstick(
        yardstick(sides["port"], sides["jax"], sides["f32"]), which)
    _print(which, margins)
    if which == "nsvae":  # the noise encoder stays frozen
        assert case.trained(res) == ["clean_enc", "noisy_enc"]
        assert all(float(d.abs().max()) == 0.0
                   for d in res["p16"][2]["noise_enc"].values())


def test_fullwidth_clean_direct_f32_and_bf16(mp):
    case = ServeCase(U, mp, U.SeededDraws(), "clean_direct", B, N)
    case.draws.install(mp)
    got, want = case.outputs(SEED)
    U.assert_close(got["f32"]["wav"], want["f32"]["wav"])
    _print("clean_direct", check_yardstick(yardstick(
        {"outputs": got["bf16"]}, {"outputs": want["bf16"]},
        {"outputs": want["f32"]}), "clean_direct"))


class _ConstantMeans:
    """`distributed` as ops/batchnorm sees it, with the batch means of
    the (re, im) pair detached: the backward treats them as constants."""

    def __init__(self, real):
        self.real = real

    def __getattr__(self, name):
        return getattr(self.real, name)

    def batch_means(self, xs, axes):
        out = self.real.batch_means(xs, axes)
        return [m.detach() for m in out] if len(xs) == 2 else out


def _drop_slope_grads(monkeypatch):
    import torch.nn.functional as F

    monkeypatch.setattr(
        "idccrn_vae_torch.models.modules.prelu",
        lambda x, alpha: F.prelu(x, alpha.detach().reshape(1).to(x.dtype)))


def _constant_bn_means(monkeypatch):
    import idccrn_vae_torch.ops.batchnorm as bn

    monkeypatch.setattr(bn, "distributed", _ConstantMeans(bn.distributed))


@pytest.mark.parametrize("mutate", [_drop_slope_grads, _constant_bn_means],
                         ids=["slope_grads_dropped", "bn_means_constant"])
def test_fullwidth_yardstick_fails_a_wrong_port_step(nsvae, monkeypatch,
                                                     mutate):
    case, res = nsvae
    mutate(monkeypatch)
    wrong = dict(res, p16=case.port_bf16(SEED))
    sides = case.sides(wrong)
    rows = yardstick(sides["port"], sides["jax"], sides["f32"])
    bad = [r for r in rows if not r["ok"]]
    print(json.dumps({mutate.__name__: [
        (r["name"], float(f"{r['port']:.4g}"), float(f"{r['bound']:.4g}"))
        for r in bad[:6]]}))
    assert bad
