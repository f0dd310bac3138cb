"""Whole `fit` runs of the port's trainers against the JAX trainers' on
the CPU, at the tiny geometry, with the same initial weights and the same
latent draws (`port_tools/trajectory_parity.SharedRun`): every epoch's
train and val loss components within the harness's bound (MAX_REL x
max(|jax|, FLOOR) x (1 + epoch), derived in its docstring), and the
discrete decisions equal: the KL weight each split applied, the
learning rates after each epoch, the epochs that improved the best val
loss and the epoch training stopped at."""

import numpy as np
import pytest

from port_tools.trajectory_parity import SharedDraws, SharedRun
from torch_port_util import (
    TINY_STFT,
    TRAIN_LR,
    assert_trajectory_match,
    configs,
    fit_both,
    train_wav,
)


def test_pretrain_fit_matches_jax(tmp_path):
    """CVAE pretraining (Adam) with a budget of 4 epochs: KL annealing
    over the first two, the plateau scheduler at patience 0 (it halves
    the LR at each epoch that does not improve), the best epoch, and the
    early stop at patience 2, which ends the run after 3 epochs."""
    from idccrn_vae_tpu.losses.vae_loss import PretrainVaeLoss as JLoss
    from idccrn_vae_tpu.train.pretrain import PretrainTrainer as JTrainer
    from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    shared = SharedRun(SharedDraws(1))
    with shared.installed():
        jc, tc = configs(stft=TINY_STFT, num_samples=2)
        warm = np.asarray([0.1, 0.5], np.float32)
        kw = dict(kl_weight=0.05, mi_weight=0.2, num_samples=2,
                  recon_loss_weight=(1.0, 0.5, 0.1))
        lr = 0.3 * TRAIN_LR
        jtr = JTrainer(jc, JLoss(warm, **kw), lr)
        ttr = PretrainTrainer(tc, PretrainVaeLoss(warm, **kw), lr,
                              device="cpu")
        for tr in (jtr, ttr):
            tr.sched_en.patience = tr.sched_de.patience = 0
        train = [train_wav(s) for s in (1, 2, 3)]
        val = [train_wav(s) for s in (10, 11)]
        cmp = fit_both(shared, "pretrain", jtr, ttr, train, val, tmp_path,
                        epochs=4, early_stop_patience=2)
    assert_trajectory_match(cmp)
    log = shared.logs["pretrain"]["jax"].as_dict()
    assert log["kl_weight"]["train"] == pytest.approx([0.1, 0.5, 0.05])
    assert log["kl_weight"]["val"] == pytest.approx([0.05] * 3)
    assert log["epochs_run"] == 3  # stopped early, not at the budget
    assert log["improved_epochs"] == [0]
    assert [lrs[0] for lrs in log["lr"]] == pytest.approx(
        [lr, lr / 2, lr / 4])


def test_supervised_fit_matches_jax(tmp_path):
    """2 epochs of the supervised DCCRN (Adam; no latent draws), on
    (noisy, clean) mixtures: with independent signals its SI-SNR term
    sits where rounding moves it by about the bound (see
    tests/test_torch_port_trajectory_phase2.py)."""
    from idccrn_vae_tpu.losses.phase2 import EteTrainSeLoss as JLoss
    from idccrn_vae_tpu.train.supervised import SupervisedTrainer as JTrainer
    from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    shared = SharedRun(SharedDraws(3))
    with shared.installed():
        jc, tc = configs(stft=TINY_STFT, causal=True, recon_type="mask",
                         skip_mode="real", lstm_hidden=8)
        weights = (1.0, 1.0, 0.5)
        jtr = JTrainer(jc, JLoss(weights), TRAIN_LR)
        ttr = SupervisedTrainer(tc, EteTrainSeLoss(weights), TRAIN_LR,
                                device="cpu")
        mix = lambda s: (train_wav(s) + train_wav(s + 1), train_wav(s))
        train = [mix(s) for s in (1, 3)]
        val = [mix(30)]
        cmp = fit_both(shared, "supervised", jtr, ttr, train, val, tmp_path,
                        epochs=2)
    assert_trajectory_match(cmp)
