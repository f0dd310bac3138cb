"""port_tools/convert_jax_checkpoint.py: a JAX checkpoint dir into a port
checkpoint dir, and a JAX run resumed by the port.

A JAX CVAE pretraining run (tiny geometry, num_samples 2, Adam, the
plateau schedulers) trains one epoch. Its dir is converted; then the
JAX trainer resumes its copy of the dir for a second epoch and the port
trainer resumes the converted dir for the same epoch, both with the
same latent draws per batch shape. The converted files hold what the
JAX trees hold (weights and BN statistics under the port's names, the
BN counters, the Adam moments, step and learning rate per parameter),
and the resumed epoch's train and val metrics agree to FIT_REL = 1e-3
LR = 3e-4  # configs/pretrained_cvae.ini [Training] lr
relative, the bound of test_torch_port_trainers.py's fit (Adam's
normalisation amplifies f32 differences of near-zero gradients).

The learning rate is configs/pretrained_cvae.ini's, 3e-4. The conv
biases ahead of each complex BN have zero gradient in exact arithmetic
(BN subtracts the batch mean), so what both sides compute for them is
rounding, which Adam turns into steps of about the learning rate, each
side its own. Train-mode BN removes them; the eval-mode BN of the
validation sees them through its running means. At the trainer tests'
1e-2 they move the validation metrics of the resumed epoch by 0.9%
(the train metrics agree to 4e-5), at the ini's rate by at most
0.04%, except the SI-SNR loss: with random weights the estimate is
nearly orthogonal to the target (SI-SNR near -28 dB, cos t = 0.04 with
t the angle between them), so its projection on the target, a
cancelling sum, moves 1 / cos t times as much as the estimate. A
relative change FIT_REL of the estimate bounds it by 20 log10(1 +
FIT_REL / cos t) dB, cos t = sqrt(r / (1 + r)), r = 10 ** (-loss / 10)
(0.21 dB here; read 0.11).
"""

import json
import math
import os
import shutil

import numpy as np
import pytest
import torch

from idccrn_vae_torch.models.from_jax import (
    jax_bn_counts,
    jax_to_port_tensors,
    jax_to_state_dict,
)
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from port_tools.convert_jax_checkpoint import convert, run_kind
from torch_port_util import (
    TINY_STFT,
    FixedNoise,
    configs,
    patch_jax_noise,
    patch_port_noise,
)

FIT_REL = 1e-3
LR = 3e-4  # configs/pretrained_cvae.ini [Training] lr
LOSS_KW = dict(kl_weight=0.05, mi_weight=0.2, num_samples=2,
               recon_loss_weight=(1.0, 0.5, 0.1))
WARM = np.asarray([0.1, 0.5], np.float32)


def _loaders(dirs, jax_side: bool):
    if jax_side:
        from idccrn_vae_tpu.data.loader import BatchLoader
        from idccrn_vae_tpu.data.segments import SegmentDataset
        from idccrn_vae_tpu.data.segments import build_segment_index
    else:
        from idccrn_vae_torch.data.loader import BatchLoader
        from idccrn_vae_torch.data.segments import SegmentDataset
        from idccrn_vae_torch.data.segments import build_segment_index
    out = []
    for split in ("train", "val"):
        d = dirs[f"clean_{split}"]
        files = sorted(os.path.join(d, f) for f in os.listdir(d))
        index = build_segment_index(files, 51, TINY_STFT["hop"], 16000,
                                    seed=7)
        out.append(BatchLoader(SegmentDataset(index, "single"), 4, seed=3,
                               num_threads=2))
    return out


def _trainers():
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.train.pretrain import PretrainTrainer
    from idccrn_vae_tpu.losses.vae_loss import PretrainVaeLoss as JLoss
    from idccrn_vae_tpu.train.pretrain import PretrainTrainer as JTrainer

    jc, tc = configs(stft=TINY_STFT, num_samples=2, skip_mode="real")
    return (JTrainer(jc, JLoss(WARM, **LOSS_KW), LR),
            PretrainTrainer(tc, PretrainVaeLoss(WARM, **LOSS_KW), LR,
                            device="cpu"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run of one epoch, its converted dir, and the second epoch
    of each side resumed from them."""
    from idccrn_vae_torch.data.synth import make_corpus

    root = str(tmp_path_factory.mktemp("convert"))
    dirs, _ = make_corpus(os.path.join(root, "corpus"), 4, 2,
                          utt_seconds=0.3, seed=5)
    jdir = os.path.join(root, "jax_run")
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_noise(mp, FixedNoise(11), module="idccrn_vae_tpu.models.vae")
        patch_port_noise(mp, FixedNoise(11),
                         module="idccrn_vae_torch.models.vae")
        jtr, _ = _trainers()
        jtr.fit(*_loaders(dirs, True), 1, jdir, save_frequency=1)
        jresume = os.path.join(root, "jax_resumed")
        shutil.copytree(jdir, jresume)
        tdir = convert(jdir, os.path.join(root, "port_run"))
        converted = {"best": CheckpointManager(tdir).load_best(),
                     "state": CheckpointManager(tdir).load_state(),
                     "meta": CheckpointManager(tdir).load_meta()}
        _, ttr = _trainers()
        # the JAX trainer resumes from the dir alone (its compiled step
        # is reused)
        _, jcurves, _ = jtr.fit(*_loaders(dirs, True), 2, jresume,
                                 save_frequency=1, resume=True)
        tcurves, _ = ttr.fit(*_loaders(dirs, False), 2, tdir,
                             save_frequency=1, resume=True)
    return {"jdir": jdir, "jresume": jresume, "tdir": tdir,
            "converted": converted, "jcurves": jcurves, "tcurves": tcurves,
            "ttr": ttr}


def test_converted_best_and_state_hold_the_jax_trees(runs):
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager as JCkpt

    src = JCkpt(runs["jdir"])
    jbest, jstate = src.load_best(), src.load_state()
    meta = runs["converted"]["meta"]
    assert meta == src.load_meta() and run_kind(meta) == "pretrain"
    assert os.path.exists(os.path.join(runs["tdir"], "loss_curves.json"))
    best, state = runs["converted"]["best"], runs["converted"]["state"]
    for name in ("enc", "dec"):
        want = jax_to_port_tensors(jbest[name])
        assert sorted(best[name]) == sorted(want)
        for k in want:
            assert torch.equal(best[name][k], want[k]), (name, k)
        want = jax_to_port_tensors(jstate[name])
        for k in want:
            assert torch.equal(state["models"][name][k], want[k]), (name, k)
        counts = jax_bn_counts(jstate[name])
        assert state["bn_count"][name].tolist() == list(counts.values())
        assert min(counts.values()) > 0
    for opt_name, model in (("opt_en", "enc"), ("opt_de", "dec")):
        opt = state["optimizers"][opt_name]
        adam = jstate[opt_name]["inner_state"][1][0]
        group = opt["param_groups"][0]
        assert group["lr"] == pytest.approx(float(
            jstate[opt_name]["hyperparams"]["learning_rate"]), rel=1e-7)
        names = [n for n, _ in runs["ttr"].models[model].named_parameters()]
        assert group["params"] == list(range(len(names)))
        for key, tree in (("exp_avg", adam["mu"]), ("exp_avg_sq", adam["nu"])):
            want = jax_to_state_dict({"params": tree,
                                      "stats": jstate[model]["stats"]})
            for i, n in enumerate(names):
                got = opt["state"][i][key]
                np.testing.assert_array_equal(
                    got.numpy(), want[n].reshape(got.shape), err_msg=n)
        assert {float(s["step"]) for s in opt["state"].values()} == {
            float(adam["count"])}


def test_port_resumes_a_jax_run_as_jax_does(runs):
    jc, tc = runs["jcurves"], runs["tcurves"]
    worst = 0.0
    for split in ("train", "val"):
        assert len(tc[split]) == len(jc[split]) == 1  # epoch 1 only
        got, want = tc[split][0], jc[split][0]
        assert set(got) == set(want)
        for k in want:
            if k == "sisnr":  # -SI-SNR in dB, see the module docstring
                r = 10 ** (-want[k] / 10)
                cos_t = math.sqrt(r / (1 + r))
                tol = 20 * math.log10(1 + FIT_REL / cos_t)
                assert abs(got[k] - want[k]) <= tol, (split, got[k], want[k])
                continue
            worst = max(worst, abs(got[k] - want[k])
                        / max(abs(want[k]), 1e-6))
    assert worst <= FIT_REL, f"worst resumed-epoch metric rel err {worst:.3e}"
    tmeta = CheckpointManager(runs["tdir"]).load_meta()
    jmeta = json.load(open(os.path.join(runs["jresume"], "meta.json")))
    assert sorted(tmeta) == sorted(jmeta)
    assert tmeta["epoch"] == jmeta["epoch"] == 1
    for k in ("sched_en", "sched_de"):
        assert tmeta[k]["num_bad"] == jmeta[k]["num_bad"], k
    assert tmeta["best_val"] == pytest.approx(jmeta["best_val"], rel=FIT_REL)
