"""One whole train step at compute="bf16" of each of the port's five
trainers against the JAX trainer on the CPU.

Each case takes the setup of the trainer's f32 step test (the same
weights, batch and injected latent noise; tests/torch_port_util.py),
with both configs at bf16: CVAE pretraining (skip_mode zero), NSVAE
posterior matching (frozen encoders), classical phase 2, adversarial
phase 2 with d_step 1 (decoder and Discriminator), and the supervised
DCCRN with datanorm. SGD, so a parameter's update is its gradient
times the learning rate.

The bound. Op by op, a bf16 output of the port is within BF16_REL = 2%
of max |ref| of JAX's (tests/test_torch_port_train_ops.py): the two
frameworks accumulate and round at different points. A step chains
about DEPTH = 25 such stages from the first encoder conv to the loss
and back (6 encoder and 6 decoder conv stages forward, the LSTM and the
dense layer, and the same stages backward). Hence:
  * each loss component: within BF16_REL relative (the forward alone);
  * each model's whole update (its parameters' updates as one vector):
    relative L2 within sqrt(DEPTH) * BF16_REL = 0.1, the stages'
    roundings adding up as independent errors;
  * each parameter's update: relative L2 within DEPTH * BF16_REL = 0.5,
    the stages' errors adding up in the same direction. A missing
    gradient reads 1 and a sign-flipped one 2.
Measured: losses within 1.4e-3, whole updates within 3.3e-2, each
parameter within 0.21 (a BN beta and a dense bias, whose gradients are
sums that cancel heavily).
DEPTH * BF16_REL is calibrated at the tiny geometry only; at the
reference geometry rounding alone passes it, and bf16 steps are held by
the yardstick measured from the f32 step instead (torch_port_util's
`yardstick`, tests/test_torch_port_fullwidth.py).

Two kinds of parameters are held otherwise:
  * A conv bias feeding a train-mode BN, which subtracts the channel's
    batch mean: its gradient is zero in exact arithmetic and what both
    sides compute is rounding. Each side's update is held below
    BF16_REL of the model's whole update (read: at most 1.13e-2).
  * A PReLU slope's gradient is one sum over a whole activation map,
    sum(ct * min(x, 0)), which cancels heavily. JAX broadcasts the
    bf16 slope over the map, and XLA:CPU reduces the transposed
    broadcast in bf16, whose result depends on the order of the sum: on
    the supervised model's last stage it is about half the float32 sum
    of the same bf16 products, and sequential bf16 sums of them in other
    orders of the map's axes even change its sign. The port accumulates
    in float32 (as JAX's own jnp.sum does for bf16). The JAX side here
    takes the slope's cotangent from the same bf16 products summed in
    float32 (`f32_slope_sum`), and the slope is then held to the 0.5
    above; without that fixture the supervised case fails on that slope.

Each test prints its margins (`pytest -rP` shows them): the worst loss,
whole-update and parameter errors, and the largest conv bias update as
a share of the model's.
"""

import json
import math

import jax
import numpy as np
import pytest
import torch

from idccrn_vae_torch.models.modules import bn_counts
from torch_port_util import (
    BF16_REL,
    NoiseStream,
    clone_state,
    f32_slope_prelu,
    nsvae_pair,
    patch_jax_noise,
    patch_port_noise,
    phase2_batch,
    phase2_pair,
    pretrain_pair,
    state_dict_of,
    supervised_pair,
    train_wav,
)

DEPTH = 25
MODEL_REL = math.sqrt(DEPTH) * BF16_REL
PARAM_REL = DEPTH * BF16_REL
BF16 = dict(compute="bf16")


@pytest.fixture
def margins():
    """The test's margins, printed when it ends."""
    out = {}
    yield out
    print(json.dumps({k: float(f"{v:.4g}") for k, v in out.items()}))


@pytest.fixture
def f32_slope_sum(monkeypatch):
    """The JAX PReLU with its slope's cotangent summed in float32: the
    same forward and input cotangent, the same bf16 products ct * x."""
    monkeypatch.setattr("idccrn_vae_tpu.models.modules.prelu",
                        f32_slope_prelu())


def check_losses(got, want, margins):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=BF16_REL, atol=1e-6, err_msg=k)
    margins["loss_rel"] = max(abs(float(got[k]) - float(want[k]))
                              / max(abs(float(want[k])), 1e-6) for k in want)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def check_update(port, before, jax_after, what, margins, prefix=""):
    """Every parameter's update of `port` against JAX's, as the module
    docstring sets out; adds the margins to `margins` under `what`."""
    want = state_dict_of(jax_after, prefix)
    got = port.state_dict()
    params = [k for k, _ in port.named_parameters()]
    d_got = {k: (got[k] - before[k]).double() for k in params}
    d_want = {k: (want[k].reshape(got[k].shape) - before[k]).double()
              for k in params}
    whole_got = torch.cat([d.flatten() for d in d_got.values()])
    whole_want = torch.cat([d.flatten() for d in d_want.values()])
    whole = _rel(whole_got, whole_want)
    assert whole <= MODEL_REL, what
    worst, bias = 0.0, 0.0
    for k in params:
        if k.endswith("bias") and "conv" in k:
            for side, d, total in (("port", d_got, whole_got),
                                   ("jax", d_want, whole_want)):
                share = float(d[k].norm() / total.norm())
                assert share <= BF16_REL, (what, k, side)
                bias = max(bias, share)
            continue
        rel = _rel(d_got[k], d_want[k])
        assert rel <= PARAM_REL, (what, k, rel)
        worst = max(worst, rel)
    margins.update({f"{what}_whole_rel": whole,
                    f"{what}_worst_param_rel": worst,
                    f"{what}_conv_bias_share": bias})


@pytest.mark.usefixtures("f32_slope_sum")
def test_pretrain_bf16_step_matches_jax(monkeypatch, margins):
    jtr, state, ttr = pretrain_pair(monkeypatch, skip_mode="zero", **BF16)
    before = {"enc": clone_state(ttr.encoder), "dec": clone_state(ttr.decoder)}
    wav = train_wav(1)
    patch_jax_noise(monkeypatch, NoiseStream(3),
                    module="idccrn_vae_tpu.models.vae")
    patch_port_noise(monkeypatch, NoiseStream(3),
                     module="idccrn_vae_torch.models.vae")
    s1, want = jtr.train_step(state, wav, jax.random.PRNGKey(0), 1)
    check_losses(ttr.train_step(wav, None, 1), want, margins)
    check_update(ttr.encoder, before["enc"], s1["enc"], "enc",
                 margins)
    check_update(ttr.decoder, before["dec"], s1["dec"], "dec",
                 margins)
    assert bn_counts(ttr.encoder).tolist() == [1] * 6


@pytest.mark.usefixtures("f32_slope_sum")
def test_nsvae_bf16_step_matches_jax(margins):
    jtr, state, ttr = nsvae_pair(**BF16)
    before = {n: clone_state(m) for n, m in ttr.models.items()}
    batch = (train_wav(20), train_wav(21), train_wav(22))
    s1, want = jtr.train_step(state, batch, jax.random.PRNGKey(0), 0)
    check_losses(ttr.train_step(batch, None, 0), want, margins)
    check_update(ttr.models["noisy_enc"], before["noisy_enc"],
                 s1["models"]["noisy_enc"], "noisy_enc", margins)
    for name in ("clean_enc", "noise_enc"):
        after = ttr.models[name].state_dict()
        assert all(torch.equal(after[k], before[name][k]) for k in after)


@pytest.mark.usefixtures("f32_slope_sum")
@pytest.mark.parametrize("adversarial", [False, True],
                         ids=["classical", "adversarial"])
def test_phase2_bf16_step_matches_jax(monkeypatch, margins, adversarial):
    kw = dict(enc_kw=BF16, dec_kw=BF16)
    if adversarial:
        kw.update(adversarial=True, d_step=1, latent_num=2)
    jtr, state, ttr = phase2_pair(monkeypatch, **kw)
    before = {n: clone_state(m) for n, m in ttr.models.items()}
    batch = phase2_batch(10)
    s1, want = jtr.train_step(state, batch, jax.random.PRNGKey(0), 0)
    got = ttr.train_step(batch, None, 0)
    assert ("dis" in got) == ("dis" in want) == adversarial
    check_losses(got, want, margins)
    trained = ["decoder", "dis"] if adversarial else list(ttr.decoders)
    for name in trained:
        check_update(ttr.models[name], before[name], s1["models"][name],
                     name, margins)
        assert bn_counts(ttr.models[name]).tolist() == [1] * 6
    after = ttr.encoder.state_dict()
    assert all(torch.equal(after[k], before["encoder"][k]) for k in after)


@pytest.mark.usefixtures("f32_slope_sum")
def test_supervised_bf16_step_matches_jax(margins):
    jtr, state, ttr = supervised_pair(datanorm=True, **BF16)
    before = clone_state(ttr.model)
    batch = (train_wav(1), train_wav(2))
    s1, want = jtr.train_step(state, batch, jax.random.PRNGKey(0), 0)
    check_losses(ttr.train_step(batch, None, 0), want, margins)
    check_update(ttr.model, before, s1["model"], "model", margins,
                 prefix="std_DCCRN")
    assert bn_counts(ttr.model).tolist() == [1] * 12
