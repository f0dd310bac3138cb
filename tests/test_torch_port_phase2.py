"""Phase-2 fine-tuning in the port against the JAX package on the CPU:
the Discriminator, the three phase-2 losses, and `Phase2Trainer`'s
classical steps (its adversarial steps, Adam and resume are in
tests/test_torch_port_phase2_adv.py).

Both trainers start from the same weights (JAX `.init`, loaded into the
port with `load_jax_variables`) and take the same batches. The frozen
NSVAE encoder draws its latent sample on both sides; `FixedNoise` hands
both the same draws for every call of one shape, since the JAX step runs
the encoder twice in one trace on a D-update batch where the port runs it
once.

Tolerances (those of tests/test_torch_port_trainers.py):
  * outputs and losses at F32_TOL; input gradients and each parameter's
    delta after one SGD step at GRAD_TOL (atol 5e-6 / rtol 5e-3); the new
    BN statistics at F32_TOL and the step counters exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.losses import phase2 as jloss
from idccrn_vae_tpu.models.discriminator import Discriminator as JDis
from idccrn_vae_tpu.models.reparam import CGauss as JGauss
from idccrn_vae_torch.losses import phase2 as tloss
from idccrn_vae_torch.models.discriminator import Discriminator
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.modules import bn_counts, frozen_bn_stats
from idccrn_vae_torch.models.reparam import CGauss as TGauss
from idccrn_vae_torch.train.phase2 import Phase2Trainer
from torch_port_util import (
    F32_TOL,
    TINY_STFT,
    check_metrics,
    check_models,
    clone_state,
    configs,
    np_vars,
    phase2_batch,
    phase2_pair,
    phase2_wav,
    state_dict_of,
    value_and_grads,
)

FIELDS = ("mu_r", "mu_i", "log_sigma", "delta_r", "delta_i")


# ---------------------------------------------------------- discriminator


@pytest.fixture(scope="module")
def jax_dis():
    """(JAX config, port config, JAX Discriminator variables): one init
    for the module's Discriminator tests."""
    jc, tc = configs(stft=TINY_STFT)
    return jc, tc, np_vars(JDis(jc).init(jax.random.PRNGKey(4)))


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_discriminator_matches_jax(jax_dis, train):
    """The score and its gradient with respect to the waveform; in train
    mode also the new running statistics (dis mode copies each batch's
    in) and the step counters."""
    jc, tc, variables = jax_dis
    dis = load_jax_variables(Discriminator(tc, device="cpu"), variables)
    dis.train(train)
    wav = phase2_wav(1)
    apply = jax.jit(lambda w: JDis(jc).apply(variables, w, train=train))
    grads = value_and_grads(lambda d: (apply(d["wav"])[0],),
                            lambda d: (dis(d["wav"]),), {"wav": wav})
    assert float(grads["wav"].abs().max()) > 0
    _, new_stats = apply(jnp.asarray(wav))
    got = dis.state_dict()
    want = state_dict_of(dict(variables, stats=np_vars(new_stats)))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.reshape(got[k].shape),
                                   err_msg=k, **F32_TOL)
    assert bn_counts(dis).tolist() == [1 if train else 0] * 6
    assert [int(s["count"]) for s in new_stats["encoder"]] == \
        [1 if train else 0] * 6


def test_frozen_bn_stats_leaves_the_statistics_alone():
    """Under frozen_bn_stats a train-mode forward whitens with the batch
    statistics as before, and leaves the running ones and the counters
    as they were (also after an exception inside the block)."""
    _, tc = configs(stft=TINY_STFT)
    dis = Discriminator(tc, device="cpu").train()
    wav = torch.from_numpy(phase2_wav(2))
    ref = dis(wav)
    before = clone_state(dis)
    with frozen_bn_stats(dis):
        torch.testing.assert_close(dis(wav), ref, rtol=0, atol=0)
    after = dis.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in after)
    assert bn_counts(dis).tolist() == [1] * 6
    with pytest.raises(ValueError), frozen_bn_stats(dis):
        raise ValueError
    dis(wav)
    assert bn_counts(dis).tolist() == [2] * 6


# ----------------------------------------------------------------- losses


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _spec_inputs(rng, prefix, b=2, f=9, t=6, n=80):
    return {f"{prefix}pred": _rand(rng, b, f, t, 2),
            f"{prefix}target": _rand(rng, b, f, t, 2),
            f"{prefix}wav": _rand(rng, b, n),
            f"{prefix}est": _rand(rng, b, n)}


def _spec_args(d, prefix):
    return tuple(d[f"{prefix}{k}"] for k in ("pred", "target", "wav", "est"))


def test_ete_train_se_loss_matches_jax():
    rng = np.random.default_rng(30)
    weights = (1.0, 0.5, 0.3)
    value_and_grads(
        lambda d: tuple(jloss.EteTrainSeLoss(weights)(*_spec_args(d, ""))),
        lambda d: tuple(tloss.EteTrainSeLoss(weights)(*_spec_args(d, ""))),
        _spec_inputs(rng, ""))


@pytest.mark.parametrize("latent_num,ref_mag_bug",
                         [(1, False), (2, False), (2, True)],
                         ids=["latent1", "latent2", "latent2-ref_mag_bug"])
def test_two_phase_loss_matches_jax(latent_num, ref_mag_bug):
    """phase_2_loss on the clean (and with latent_num 2 the noise)
    decoder's outputs: every field of TwoPhaseOut and its gradient."""
    rng = np.random.default_rng(31)
    inputs = {**_spec_inputs(rng, "c_"), **_spec_inputs(rng, "n_")}
    kw = dict(recon_loss_weight=(1.0, 0.7, 0.2), alpha=0.8,
              latent_num=latent_num, ref_mag_bug=ref_mag_bug)

    def run(mod, d):
        return tuple(mod.TwoPhaseLoss(**kw).phase_2_loss(
            *_spec_args(d, "c_"), *_spec_args(d, "n_")))

    value_and_grads(lambda d: run(jloss, d), lambda d: run(tloss, d), inputs)


@pytest.mark.parametrize("latent_num", [1, 2])
def test_phase_1_loss_matches_jax(latent_num):
    rng = np.random.default_rng(32)
    b, t, h = 2, 5, 3
    scales = {"mu_r": 0.5, "mu_i": 0.5, "log_sigma": 0.3, "delta_r": 0.3,
              "delta_i": 0.3}
    names = ("clean", "noise", "speech", "noisy_noise")
    inputs = {f"{n}_{k}": _rand(rng, b, t, h, scale=s)
              for n in names for k, s in scales.items()}

    def run(mod, gauss, d):
        g = [gauss(**{k: d[f"{n}_{k}"] for k in FIELDS}) for n in names]
        return tuple(mod.TwoPhaseLoss((1.0, 1.0, 0.0), alpha=0.7,
                                      latent_num=latent_num).phase_1_loss(
            *g[:3], g[3] if latent_num == 2 else None))

    value_and_grads(lambda d: run(jloss, JGauss, d),
                    lambda d: run(tloss, TGauss, d), inputs)


def test_adversarial_losses_match_jax():
    """The LSGAN D objective and the generator's 0.5 * (D(est) - 1)^2 +
    SI-SNR, with their gradients."""
    rng = np.random.default_rng(33)
    inputs = {"s_true": _rand(rng, 2, 7, 1), "s_est": _rand(rng, 2, 7, 1),
              "clean": _rand(rng, 2, 90), "est": _rand(rng, 2, 90)}

    def run(mod, d):
        loss = mod.AdversarialPhase2Loss(1)
        return (loss.discriminator_loss(d["s_true"], d["s_est"]),
                *loss.generator_loss(d["clean"], d["est"], d["s_est"]))

    value_and_grads(lambda d: run(jloss, d), lambda d: run(tloss, d), inputs)


# --------------------------------------------------------------- trainers


CLASSICAL = {
    "latent1": dict(),
    "latent2-noise_decoder": dict(latent_num=2),
    "double-channel": dict(latent_num=2, enc_kw=dict(channel_mode="double")),
    "skip_layer": dict(decode_update="skip_layer",
                       dec_kw=dict(skip_to_use=(0, 2))),
}


@pytest.mark.parametrize("case", list(CLASSICAL))
def test_classical_sgd_step_matches_jax(monkeypatch, case):
    """One SGD step: the losses, each trained decoder's deltas, BN
    statistics and counters; the frozen encoder byte-identical with its
    counters at 0; for skip_layer the frozen stages byte-identical while
    their BN statistics still update; then the validation metrics."""
    jtr, state, ttr = phase2_pair(monkeypatch, **CLASSICAL[case])
    assert (ttr.noise_decoder is not None) == ("noise_decoder" in
                                               state["models"])
    before = {n: clone_state(m) for n, m in ttr.models.items()}
    batch = phase2_batch(10)
    s1, want = jtr.train_step(state, batch, jax.random.PRNGKey(0), 0)
    got = ttr.train_step(batch, None, 0)
    check_metrics(got, want)
    for name, dec in ttr.decoders.items():
        assert check_models(dec, before[name], s1["models"][name],
                            name) > 1e-4
        assert bn_counts(dec).tolist() == [1] * 6
    after = ttr.encoder.state_dict()
    assert all(torch.equal(after[k], before["encoder"][k]) for k in after)
    assert bn_counts(ttr.encoder).tolist() == [0] * 6
    if case == "skip_layer":
        n = len(ttr.decoder.decoders)
        trained = {n - 1 - i for i in ttr.dec_cfg.skip_to_use}
        assert trained == {5, 3}
        for name, dec in ttr.decoders.items():
            for k, v in dec.state_dict().items():
                stage = (int(k.split(".")[1]) if k.startswith("decoders.")
                         else None)
                if stage in trained or k.split(".")[-1].startswith(
                        ("running", "V")):
                    continue
                assert torch.equal(v, before[name][k]), (name, k)
            assert not torch.equal(dec.decoders[0].bn.Vrr,
                                   before[name]["decoders.0.bn.Vrr"])
    check_metrics(ttr.eval_step(batch, None, 0),
                  jtr.eval_step(s1, batch, jax.random.PRNGKey(1), 0))


def test_phase2_trainer_refuses_bad_arguments():
    _, tc = configs()
    _, dec2 = configs(latent_num=2, skip_mode="runtime")
    loss = tloss.TwoPhaseLoss((1.0, 1.0, 0.0), 1.0, 2)
    with pytest.raises(ValueError, match="noise latent"):
        Phase2Trainer(tc, dec2, loss, 1e-3, device="cpu")
    with pytest.raises(ValueError, match="decode_update"):
        Phase2Trainer(tc, tc, loss, 1e-3, decode_update="dense",
                      device="cpu")
    with pytest.raises(NotImplementedError, match="remat"):
        Phase2Trainer(tc, dataclasses.replace(tc, remat=True), loss, 1e-3,
                      device="cpu")
