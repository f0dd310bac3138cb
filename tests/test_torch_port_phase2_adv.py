"""Phase-2 adversarial fine-tuning in the port against the JAX package on
the CPU: `Phase2Trainer`'s LSGAN steps with SGD for d_step 1 and 2, its
two Adams, and a port-only fit that resumes the d_step phase.

Both trainers start from the same weights and take the same batches,
and the frozen encoder's latent draws are injected on both sides
(`torch_port_util.phase2_pair`).

Tolerances (those of tests/test_torch_port_trainers.py):
  * losses at F32_TOL; each parameter's delta after an SGD step at
    GRAD_TOL (atol 5e-6 / rtol 5e-3); the new BN statistics at F32_TOL
    and the step counters exactly;
  * Adam: the deltas after two steps at atol 1e-2 * lr / rtol 5e-3 (Adam
    divides by sqrt(v), so f32 differences of a near-zero gradient become
    differences of order lr in the update).
"""

import jax
import numpy as np
import pytest

from idccrn_vae_torch.losses import phase2 as tloss
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.modules import bn_counts
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from idccrn_vae_torch.train.phase2 import Phase2Trainer
from torch_port_util import (
    PHASE2_LR,
    TINY_STFT,
    check_metrics,
    check_models,
    clone_state,
    configs,
    np_vars,
    phase2_batch,
    phase2_pair,
    state_dict_of,
)


@pytest.mark.parametrize("d_step", [1, 2])
def test_adversarial_sgd_steps_match_jax(monkeypatch, d_step):
    """Two batches of SGD steps: D updates on the batches where
    batch_counter % d_step == 0, before the generator, which then trains
    through the updated D. After each step the metrics (with `dis` on the
    D-update batches), the decoder's and D's deltas and statistics, and
    every BN counter (D's moves once per D update)."""
    jtr, state, ttr = phase2_pair(monkeypatch, adversarial=True,
                                   d_step=d_step, latent_num=2)
    assert ttr.noise_decoder is None and "noise_decoder" not in \
        state["models"]
    d_updates = 0
    for step in range(2):
        before = {n: clone_state(m) for n, m in ttr.models.items()}
        batch = phase2_batch(20 + 3 * step)
        state, want = jtr.train_step(state, batch,
                                     jax.random.PRNGKey(step), 0)
        got = ttr.train_step(batch, None, 0)
        d_updates += step % d_step == 0
        assert ("dis" in got) == ("dis" in want) == (step % d_step == 0)
        check_metrics(got, want)
        check_models(ttr.decoder, before["decoder"],
                     state["models"]["decoder"], f"decoder {step}")
        moved = check_models(ttr.dis, before["dis"], state["models"]["dis"],
                             f"dis {step}")
        assert (moved > 1e-6) == (step % d_step == 0), moved
        assert bn_counts(ttr.dis).tolist() == [d_updates] * 6
        assert bn_counts(ttr.decoder).tolist() == [step + 1] * 6
    assert ttr._batch_counter == jtr._batch_counter == 2
    # validation: eval-mode D's loss on (clean, estimate) as `dis`, from
    # the JAX weights after the steps (the port's own differ within
    # GRAD_TOL, which eval-mode BN with two steps' running statistics
    # amplifies to ~1.4e-4 in the SI-SNR)
    for name in ("decoder", "dis"):
        load_jax_variables(ttr.models[name], np_vars(state["models"][name]))
    batch = phase2_batch(40)
    got = ttr.eval_step(batch, None, 0)
    assert "dis" in got
    check_metrics(got, jtr.eval_step(state, batch, jax.random.PRNGKey(7), 0))


def test_adam_steps_match_jax(monkeypatch):
    """The real optimizers: the two Adams (weight decay 1e-3) of an
    adversarial run, two steps."""
    jtr, state, ttr = phase2_pair(monkeypatch, sgd=False, adversarial=True)
    models = {"decoder": ttr.decoder, "dis": ttr.dis}
    before = {n: clone_state(m) for n, m in models.items()}
    for step in range(2):
        batch = phase2_batch(50 + 3 * step)
        state, want = jtr.train_step(state, batch,
                                     jax.random.PRNGKey(step), 0)
        check_metrics(ttr.train_step(batch, None, 0), want)
    for name, m in models.items():
        lr = PHASE2_LR if name == "decoder" else 2 * PHASE2_LR
        tol = dict(atol=1e-2 * lr, rtol=5e-3)
        want_sd = state_dict_of(state["models"][name])
        g_max = max(float(p.grad.abs().max()) for p in m.parameters())
        for k, v in m.named_parameters():
            if k.endswith("bias") and "conv" in k:
                # ahead of a train-mode BN, which subtracts the channel's
                # batch mean: zero up to rounding, which Adam scales to
                # steps of up to lr either way (test_torch_port_trainers.py)
                assert float(v.grad.abs().max()) <= 1e-5 * g_max, (name, k)
                continue
            np.testing.assert_allclose(
                (v.detach() - before[name][k]).numpy(),
                (want_sd[k].reshape(v.shape) - before[name][k]).numpy(),
                err_msg=f"{name} {k}", **tol)
    assert ttr.opt.state_dict()["state"][0]["step"] == 2
    assert ttr.opt_dis.state_dict()["state"][0]["step"] == 2


# ------------------------------------------------------------ fit, resume


@pytest.fixture(scope="module")
def triplet_loaders(tmp_path_factory):
    """Train/val BatchLoaders over a tiny synthetic triplet corpus."""
    import os

    from idccrn_vae_torch.data.loader import BatchLoader
    from idccrn_vae_torch.data.segments import (
        SegmentDataset,
        build_segment_index,
    )
    from idccrn_vae_torch.data.synth import make_corpus

    root = str(tmp_path_factory.mktemp("corpus"))
    dirs, _ = make_corpus(root, 2, 1, utt_seconds=0.3, seed=6)

    def loader(split, batch):
        d = dirs[f"noisy_{split}"]
        files = sorted(os.path.join(d, f) for f in os.listdir(d))
        index = build_segment_index(files, 51, 8, 16000, seed=7)
        return BatchLoader(SegmentDataset(index, "triplet",
                                          dirs[f"clean_{split}"],
                                          dirs[f"noise_{split}"]),
                           batch, seed=3, num_threads=2)

    return lambda: (loader("train", 7), loader("val", 6))


def _fit(save_dir, loaders, epochs, resume=False):
    _, tenc = configs(stft=TINY_STFT)
    _, tdec = configs(stft=TINY_STFT, skip_mode="runtime", recon_type="mask")
    ttr = Phase2Trainer(tenc, tdec, tloss.TwoPhaseLoss((1.0, 1.0, 0.0), 1.0,
                                                       1), 1e-3,
                        adversarial=True, d_step=2, device="cpu")
    curves, best = ttr.fit(*loaders(), epochs, save_dir, save_frequency=1,
                           resume=resume)
    return ttr, curves, best


def test_fit_resumes_the_d_step_phase(tmp_path, triplet_loaders):
    """An adversarial run with d_step 2 over an odd number of batches per
    epoch, stopped after two epochs and resumed, repeats the
    uninterrupted run's third epoch: batch_counter, sched_dis, D's Adam
    and the BN counters come back from the run dir. best.pt holds every
    model, and model selection reads the val `recon_sisnr`."""
    n_batches = len(triplet_loaders()[0])
    assert n_batches % 2 == 1, n_batches
    full, curves, best = _fit(str(tmp_path / "full"), triplet_loaders, 3)
    assert best == min(row["recon_sisnr"] for row in curves["val"])
    part = str(tmp_path / "part")
    _fit(part, triplet_loaders, 2)
    meta = CheckpointManager(part).load_meta()
    assert meta["batch_counter"] == 2 * n_batches
    assert meta["adversarial"] is True and "sched_dis" in meta
    assert sorted(CheckpointManager(part).load_best()) == [
        "decoder", "dis", "encoder"]
    resumed, rest, _ = _fit(part, triplet_loaders, 3, resume=True)
    assert len(rest["train"]) == 1
    for split in ("train", "val"):
        for k, v in curves[split][2].items():
            assert rest[split][0][k] == pytest.approx(v, rel=1e-6), (split, k)
    assert resumed._batch_counter == full._batch_counter == 3 * n_batches
    for name in ("decoder", "dis"):
        assert bn_counts(resumed.models[name]).tolist() == \
            bn_counts(full.models[name]).tolist()
    assert CheckpointManager(part).load_meta()["epoch"] == 2
