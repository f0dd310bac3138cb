"""Whole `fit` runs of the port's phase-2 trainer against the JAX
trainer's on the CPU, classical and adversarial, at the tiny geometry,
with the same initial weights and latent draws: the bounds and decisions
of tests/test_torch_port_trajectory.py."""

import pytest

from port_tools.trajectory_parity import SharedDraws, SharedRun
from torch_port_util import (
    PHASE2_LR,
    TINY_STFT,
    assert_trajectory_match,
    configs,
    fit_both,
    phase2_batch,
)


def _mixture(seed):
    """(noisy, clean, noise) with noisy = clean + noise. The decoders'
    masked estimates then correlate with the clean target; on independent
    signals the SI-SNR term sits near -40 dB, where a rounding of the
    estimate moves it by percents."""
    _noisy, clean, noise = phase2_batch(seed)
    return clean + noise, clean, noise


@pytest.mark.parametrize("adversarial", [False, True])
def test_phase2_fit_matches_jax(adversarial, tmp_path):
    """2 epochs of phase-2 decoder fine-tuning (Adam), classical or
    adversarial at d_step 2 (D updates on every other batch)."""
    from idccrn_vae_tpu.losses import phase2 as jloss
    from idccrn_vae_tpu.train.phase2 import Phase2Trainer as JTrainer
    from idccrn_vae_torch.losses import phase2 as tloss
    from idccrn_vae_torch.train.phase2 import Phase2Trainer

    shared = SharedRun(SharedDraws(2))
    with shared.installed():
        jenc, tenc = configs(stft=TINY_STFT, latent_num=1)
        jdec, tdec = configs(stft=TINY_STFT, latent_num=1,
                             skip_mode="runtime", recon_type="mask")
        kw = dict(recon_loss_weight=(1.0, 0.5, 0.2), alpha=1.0,
                  latent_num=1)
        tkw = dict(adversarial=adversarial, dis_lr=2 * PHASE2_LR, d_step=2)
        jtr = JTrainer(jenc, jdec, jloss.TwoPhaseLoss(**kw), PHASE2_LR,
                       **tkw)
        ttr = Phase2Trainer(tenc, tdec, tloss.TwoPhaseLoss(**kw), PHASE2_LR,
                            device="cpu", **tkw)
        train = [_mixture(s) for s in (1, 4, 7)]
        val = [_mixture(s) for s in (20, 23)]
        cmp = fit_both(shared, "phase2", jtr, ttr, train, val, tmp_path,
                        epochs=2)
    assert_trajectory_match(cmp)
    keys = set(shared.logs["phase2"]["port"].curves["train"][0])
    assert ("dis" in keys) == adversarial
