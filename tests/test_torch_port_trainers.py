"""The port's trainers against the JAX trainers on the CPU.

Both sides start from the same weights (JAX `.init`, loaded into the port
with `load_jax_variables`, BN step counters included), take the same
batch and, where a decoder consumes latent samples, the same injected
noise (`patch_jax_noise` / `patch_port_noise`; the JAX step draws once
per traced shape, so each comparison keeps one batch shape and hands the
port the same draws at every step). skip_mode 'prob''s coin is injected
on both sides.

Tolerances:
  * one SGD step: every loss component at F32_TOL, each parameter's
    delta at atol 5e-6 / rtol 5e-3 (tests/test_oracle_train_step.py:130),
    the new BN statistics at F32_TOL and the counters exactly; the
    validation after it at F32_TOL (with datanorm at rtol 1e-3: its
    eval-mode outputs are ill-conditioned, see the test);
  * Adam: its update divides by sqrt(v), so f32 differences of a
    gradient become differences of the update of ~lr scale where the
    gradient is near zero; the deltas after two steps are held at
    atol 1e-2 * lr / rtol 5e-3;
  * NSVAE fit: per-epoch train/val metrics to 1e-3 relative (Adam's
    normalisation amplifies f32 differences in near-zero gradients over
    the epochs; the JAX package's own 14-epoch parity against the
    reference reached 8.7e-4, TRAJECTORY_PARITY.json), the same best
    epoch, patience and learning rate.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.train import optim as joptim
from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.modules import bn_counts
from idccrn_vae_torch.train import optim as toptim
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from idccrn_vae_torch.train.nsvae import NsvaeTrainer
from idccrn_vae_torch.train.pretrain import PretrainTrainer
from torch_port_util import (
    F32_TOL,
    TRAIN_LR,
    NoiseStream,
    check_metrics as _check_metrics,
    check_models as _check_models,
    configs,
    np_vars,
    nsvae_pair as _nsvae_pair,
    patch_jax_noise,
    patch_port_noise,
    pretrain_pair as _pretrain_pair,
    state_dict_of as _sd,
    train_wav as _wav,
)

LR = TRAIN_LR
FIT_REL = 1e-3


@pytest.mark.parametrize("case", [
    dict(skip_mode="none"), dict(skip_mode="zero"),
    dict(skip_mode="real"),
    dict(skip_mode="prob", skip_prob=1, coin=True),
    dict(skip_mode="prob", skip_prob=2, coin=False),
    dict(skip_mode="real", latent="fc", skip_to_use=(0, 2, 5)),
    dict(skip_mode="zero", datanorm=True),
], ids=["none", "zero", "real", "prob-real", "prob-self", "fc", "datanorm"])
def test_pretrain_sgd_step_matches_jax(monkeypatch, case):
    case = dict(case)
    coin = case.pop("coin", None)
    jtr, state, ttr = _pretrain_pair(monkeypatch, **case)
    before = {"enc": {k: v.clone() for k, v in
                      ttr.encoder.state_dict().items()},
              "dec": {k: v.clone() for k, v in
                      ttr.decoder.state_dict().items()}}
    wav = _wav(1)
    patch_jax_noise(monkeypatch, NoiseStream(3),
                    module="idccrn_vae_tpu.models.vae")
    patch_port_noise(monkeypatch, NoiseStream(3),
                     module="idccrn_vae_torch.models.vae")
    if coin is not None:
        monkeypatch.setattr(jax.random, "bernoulli",
                            lambda key, p: jnp.asarray(coin))
    s1, want = jtr.train_step(state, wav, jax.random.PRNGKey(0), 1)
    got = ttr.train_step(wav, None, 1, skip_coin=coin)
    _check_metrics(got, want)
    moved = max(_check_models(ttr.encoder, before["enc"], s1["enc"], "enc"),
                _check_models(ttr.decoder, before["dec"], s1["dec"], "dec"))
    assert moved > 1e-4, moved
    assert bn_counts(ttr.encoder).tolist() == [1] * 6
    # validation: eval mode, the fully-warm KL weight, state untouched.
    # Eval-mode BN whitens with the running statistics of the pre-step
    # weights, which the step moved: the outputs grow (with datanorm the
    # recon loss reaches ~1e6) and the f32 differences of the deltas
    # (held above at rtol 5e-3) show at ~1e-4 there, so that case's
    # validation is held at 1e-3.
    patch_jax_noise(monkeypatch, NoiseStream(4),
                    module="idccrn_vae_tpu.models.vae")
    patch_port_noise(monkeypatch, NoiseStream(4),
                     module="idccrn_vae_torch.models.vae")
    _check_metrics(ttr.eval_step(wav, None, 0),
                   jtr.eval_step(s1, wav, jax.random.PRNGKey(1), 0),
                   dict(atol=1e-4, rtol=1e-3) if "datanorm" in case
                   else F32_TOL)
    assert bn_counts(ttr.encoder).tolist() == [1] * 6


def test_pretrain_adam_steps_match_jax(monkeypatch):
    """The real optimizers, Adam with weight decay 1e-3 on both sides,
    two steps, from weights a JAX step has warmed (BN counters 1: the
    port's first step blends the running statistics, as JAX's second
    does)."""
    jtr, state, ttr = _pretrain_pair(monkeypatch, sgd=False, warm=True,
                                     skip_mode="real")
    assert bn_counts(ttr.decoder).tolist() == [1] * 6
    models = {"enc": ttr.encoder, "dec": ttr.decoder}
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in models.items()}
    for step in range(2):
        wav = _wav(10 + step)
        # the JAX step retraces once its optimizer state's dtypes settle
        # after the first update, and a trace draws the patched noise:
        # both sides get a fresh stream at every step
        patch_jax_noise(monkeypatch, NoiseStream(6),
                        module="idccrn_vae_tpu.models.vae")
        state, want = jtr.train_step(state, wav, jax.random.PRNGKey(step), 2)
        patch_port_noise(monkeypatch, NoiseStream(6),
                         module="idccrn_vae_torch.models.vae")
        got = ttr.train_step(wav, None, 2)
        _check_metrics(got, want)
    lr_tol = dict(atol=1e-2 * LR, rtol=5e-3)
    worst = 0.0
    for name, m in models.items():
        want_sd = _sd(state[name])
        g_max = max(float(p.grad.abs().max()) for p in m.parameters())
        for k, v in m.named_parameters():
            if k.endswith("bias") and "conv" in k:
                # a conv bias feeds a train-mode BN, which subtracts the
                # per-channel batch mean: its gradient is zero up to f32
                # rounding, and Adam scales that rounding noise to steps
                # of up to lr in either direction on each side
                assert float(v.grad.abs().max()) <= 1e-5 * g_max, k
                continue
            d_got = v.detach() - before[name][k]
            d_want = want_sd[k].reshape(v.shape) - before[name][k]
            worst = max(worst, float((d_got - d_want).abs().max()))
            np.testing.assert_allclose(d_got.numpy(), d_want.numpy(),
                                       err_msg=f"{name} {k}", **lr_tol)
    assert worst <= lr_tol["atol"], worst
    assert bn_counts(ttr.decoder).tolist() == [3] * 6
    assert ttr.opt_en.state_dict()["state"][0]["step"] == 2


# ------------------------------------------------------------------ nsvae


@pytest.mark.parametrize("unfreeze", [False, True],
                         ids=["frozen", "clean_enc-unfrozen"])
def test_nsvae_sgd_step_matches_jax(unfreeze):
    trainable = {"clean_enc": True} if unfreeze else None
    jtr, state, ttr = _nsvae_pair(trainable)
    before = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in ttr.models.items()}
    batch = (_wav(20), _wav(21), _wav(22))
    s1, want = jtr.train_step(state, batch, jax.random.PRNGKey(0), 0)
    got = ttr.train_step(batch, None, 0)
    _check_metrics(got, want)
    assert _check_models(ttr.models["noisy_enc"], before["noisy_enc"],
                         s1["models"]["noisy_enc"], "noisy_enc") > 1e-4
    for name in ("clean_enc", "noise_enc"):
        m = ttr.models[name]
        if name == "clean_enc" and unfreeze:
            _check_models(m, before[name], s1["models"][name], name)
            assert bn_counts(m).tolist() == [1] * 6
            continue
        # frozen: eval mode under no_grad, weights and statistics
        # byte-identical, counters untouched
        after = m.state_dict()
        assert all(torch.equal(after[k], before[name][k]) for k in after)
        assert bn_counts(m).tolist() == [0] * 6
        assert not any(p.requires_grad for p in m.parameters())
    _check_metrics(ttr.eval_step(batch, None, 0),
                   jtr.eval_step(s1, batch, jax.random.PRNGKey(1), 0))


# ------------------------------------------------------------ nsvae fit


@pytest.fixture(scope="module")
def triplet_corpus(tmp_path_factory):
    """A tiny make_corpus triplet corpus and its segment index, built by
    both packages (the indexes must be equal)."""
    from idccrn_vae_tpu.data.segments import build_segment_index as j_index
    from idccrn_vae_torch.data.segments import build_segment_index
    from idccrn_vae_torch.data.synth import make_corpus

    root = str(tmp_path_factory.mktemp("corpus"))
    dirs, _ = make_corpus(root, 4, 2, utt_seconds=0.3, seed=5)
    out = {}
    for split in ("train", "val"):
        files = sorted(os.path.join(dirs[f"noisy_{split}"], f)
                       for f in os.listdir(dirs[f"noisy_{split}"]))
        index = build_segment_index(files, 51, 8, 16000, seed=7)
        assert index == j_index(files, 51, 8, 16000, seed=7)
        out[split] = (index, dirs[f"clean_{split}"], dirs[f"noise_{split}"])
    return out


def _loaders(corpus, jax_side: bool):
    if jax_side:
        from idccrn_vae_tpu.data.loader import BatchLoader
        from idccrn_vae_tpu.data.segments import SegmentDataset
    else:
        from idccrn_vae_torch.data.loader import BatchLoader
        from idccrn_vae_torch.data.segments import SegmentDataset
    return [BatchLoader(SegmentDataset(*corpus[split][:1], "triplet",
                                       *corpus[split][1:]), 4, seed=3,
                        num_threads=2) for split in ("train", "val")]


def _port_fit(state, corpus, save_dir, epochs, resume=False):
    _, _, ttr = _nsvae_pair(sgd=False)
    for name, m in ttr.models.items():
        load_jax_variables(m, np_vars(state["models"][name]))
    curves, best = ttr.fit(*_loaders(corpus, False), epochs, save_dir,
                           save_frequency=1, resume=resume)
    return ttr, curves, best


def test_nsvae_fit_matches_jax_and_resumes(tmp_path, triplet_corpus):
    """Three epochs of fit (Adam, the plateau scheduler, best and state
    checkpoints) on both sides; then a port run stopped after epoch 1
    and resumed gives the uninterrupted run's epoch 2."""
    jtr, state, _ = _nsvae_pair(sgd=False)
    pretrained = state["models"]
    jstate, jcurves, jbest = jtr.fit(*_loaders(triplet_corpus, True), 3,
                                     str(tmp_path / "j"), save_frequency=1,
                                     pretrained=pretrained)
    ttr, curves, best = _port_fit(state, triplet_corpus,
                                  str(tmp_path / "t"), 3)
    worst = 0.0
    for split in ("train", "val"):
        assert len(curves[split]) == len(jcurves[split]) == 3
        for got, want in zip(curves[split], jcurves[split]):
            assert set(got) == set(want)
            for k in want:
                rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
                worst = max(worst, rel)
    assert worst <= FIT_REL, f"worst per-epoch metric rel err {worst:.3e}"
    assert abs(best - jbest) <= FIT_REL * abs(jbest)
    best_epoch = lambda c: int(np.argmin([v["total"] for v in c["val"]]))
    assert best_epoch(curves) == best_epoch(jcurves)
    jmeta = json.load(open(tmp_path / "j" / "meta.json"))
    tmeta = CheckpointManager(str(tmp_path / "t")).load_meta()
    assert sorted(tmeta) == sorted(jmeta)
    for k in ("epoch", "patience", "trainable", "model_name"):
        assert tmeta[k] == jmeta[k], k
    assert tmeta["sched"]["num_bad"] == jmeta["sched"]["num_bad"]
    assert toptim.get_learning_rate(ttr.opt) == pytest.approx(
        joptim.get_learning_rate(jstate["opt"]), rel=1e-6)
    assert sorted(os.listdir(tmp_path / "t")) == [
        "best.pt", "loss_curves.json", "meta.json", "state.pt"]

    # resume: two epochs, then a fresh trainer continues at epoch 2
    part = str(tmp_path / "resume")
    _port_fit(state, triplet_corpus, part, 2)
    saved = CheckpointManager(part).load_state()
    assert saved["bn_count"]["noisy_enc"].tolist() == [
        2 * len(_loaders(triplet_corpus, False)[0])] * 6
    assert saved["bn_count"]["clean_enc"].tolist() == [0] * 6
    ttr2, rest, _ = _port_fit(state, triplet_corpus, part, 3, resume=True)
    assert len(rest["train"]) == 1
    for split in ("train", "val"):
        for k, v in curves[split][2].items():
            assert rest[split][0][k] == pytest.approx(v, rel=1e-6), k
    assert bn_counts(ttr2.models["noisy_enc"]).tolist() == \
        bn_counts(ttr.models["noisy_enc"]).tolist()
    assert CheckpointManager(part).load_meta()["epoch"] == 2


def test_bridge_carries_the_bn_counter():
    """load_jax_variables fills each BN counter from the JAX `count`."""
    jc, tc = configs()
    from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JEnc
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder

    variables = np_vars(JEnc(jc).init(jax.random.PRNGKey(0)))
    for i, s in enumerate(variables["stats"]["encoder"]):
        s["count"] = np.asarray(3 + i, np.int32)
    enc = load_jax_variables(NsvaeEncoder(tc, device="cpu"), variables)
    assert bn_counts(enc).tolist() == [3, 4, 5, 6, 7, 8]
    assert "count" not in " ".join(enc.state_dict())


def test_plateau_scheduler_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.0002, 3.9999, 4.1, 4.2, 3.0, 3.0, 3.0, 3.0,
               3.0, 2.0, float("nan"), 2.5, 2.5, 2.5, 2.5]
    jsched, tsched = joptim.PlateauScheduler(0.5, 3), toptim.PlateauScheduler(
        0.5, 3)
    jopt = joptim.make_adam(1e-3).init({"w": jnp.zeros(2)})
    topt = toptim.make_adam([torch.nn.Parameter(torch.zeros(2))], 1e-3)
    reductions = 0
    for m in metrics:
        jopt, jred = jsched.step(m, jopt)
        tred = tsched.step(m, topt)
        assert tred == jred
        reductions += tred
        assert tsched.state_dict() == jsched.state_dict()
        assert toptim.get_learning_rate(topt) == pytest.approx(
            joptim.get_learning_rate(jopt), rel=1e-6)
    assert reductions >= 2
    tsched2 = toptim.PlateauScheduler(0.5, 3)
    tsched2.load_state_dict(json.loads(json.dumps(tsched.state_dict())))
    assert tsched2.state_dict() == tsched.state_dict()


def test_trainers_refuse_remat_and_int8():
    """remat trains (each stage recomputed in the backward; the steps
    are held against remat off and JAX in tests/test_torch_port_remat.py):
    both trainers build and step with it. int8 serves but does not
    train: JAX's ValueError, with or without remat
    (tests/test_torch_port_int8.py covers all five trainers)."""
    _, tc = configs(remat=True)
    loss = PretrainVaeLoss(np.zeros(0, np.float32), 1.0, num_samples=1)
    pre = PretrainTrainer(tc, loss, 1e-3, device="cpu")
    _, noisy = configs(latent_num=2, remat=True)
    ns = NsvaeTrainer(tc, noisy, NsvaeTrueKlLoss(1, 0, 1, 0, noisy), 1e-3,
                      device="cpu")
    gen = torch.Generator().manual_seed(0)
    for metrics in (pre.train_step(_wav(30), gen, 0),
                    ns.train_step((_wav(31), _wav(32), _wav(33)), gen, 0)):
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert bn_counts(pre.encoder).tolist() == [1] * 6
    assert bn_counts(ns.models["noisy_enc"]).tolist() == [1] * 6
    _, int8 = configs(compute="int8", remat=True)
    with pytest.raises(ValueError, match="serving-only"):
        PretrainTrainer(int8, loss, 1e-3, device="cpu")
    bf16 = dataclasses.replace(tc, remat=False, compute="bf16")
    PretrainTrainer(bf16, loss, 1e-3, device="cpu")
