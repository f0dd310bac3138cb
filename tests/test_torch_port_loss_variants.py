"""The port's loss variants (`losses/vae_variants.py`,
`losses/nsvae_variants.py`) against the JAX package's, on the cases of
tests/test_loss_variants.py and their options.

Both sides take the same float32 inputs, made from a seed with numpy:
posteriors as in tests/test_losses.py (|delta| safely inside sigma),
latent samples, spectrograms and waveforms. Every output is held at
atol/rtol 1e-5, and so is the gradient of one fixed random contraction of
the outputs with respect to every input (`jax.grad` on the JAX side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.losses import nsvae_variants as jnv
from idccrn_vae_tpu.losses import vae_variants as jvv
from idccrn_vae_tpu.models.config import DccrnConfig as JaxConfig
from idccrn_vae_tpu.models.reparam import CGauss as JGauss
from idccrn_vae_torch.losses import nsvae_variants as tnv
from idccrn_vae_torch.losses import vae_variants as tvv
from idccrn_vae_torch.models.config import DccrnConfig as TorchConfig
from idccrn_vae_torch.models.reparam import CGauss as TGauss
from torch_port_util import to_np

TOL = dict(atol=1e-5, rtol=1e-5)
FIELDS = ("mu_r", "mu_i", "log_sigma", "delta_r", "delta_i")
B, T, H, S = 2, 5, 4, 3


def gauss_inputs(name, b, t, h, seed, spread=0.5):
    """Posterior fields `name.<field>` (tests/test_losses.py's draws)."""
    rng = np.random.default_rng(seed)
    log_sigma = rng.uniform(-1.0, 1.0, (b, t, h))
    mag = np.exp(log_sigma) * rng.uniform(0.0, 0.7, (b, t, h))
    ang = rng.uniform(-np.pi, np.pi, (b, t, h))
    vals = (rng.normal(0, spread, (b, t, h)), rng.normal(0, spread, (b, t, h)),
            log_sigma, mag * np.cos(ang), mag * np.sin(ang))
    return {f"{name}.{f}": v.astype(np.float32) for f, v in zip(FIELDS, vals)}


def normal(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def gauss(d, name, cls):
    return cls(*(d[f"{name}.{f}"] for f in FIELDS))


def compare(fn_j, fn_t, inputs, seed=0):
    """Outputs and the gradients of a random contraction, at TOL."""
    rng = np.random.default_rng(seed)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    outs_j = fn_j(jin)
    ws = [rng.standard_normal(np.shape(o)).astype(np.float32)
          for o in outs_j]
    grads_j = jax.grad(lambda d: sum(jnp.sum(o * w) for o, w in
                                     zip(fn_j(d), ws)))(jin)
    tin = {k: torch.tensor(v, requires_grad=True) for k, v in inputs.items()}
    outs_t = fn_t(tin)
    assert len(outs_t) == len(outs_j)
    for i, (ot, oj) in enumerate(zip(outs_t, outs_j)):
        np.testing.assert_allclose(to_np(ot), to_np(oj), err_msg=f"out {i}",
                                   **TOL)
    sum((o * torch.from_numpy(w)).sum() for o, w in zip(outs_t, ws)
        ).backward()
    for k, t in tin.items():
        g = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_allclose(to_np(g), to_np(grads_j[k]),
                                   err_msg=f"grad {k}", **TOL)


def vae_inputs():
    return {**gauss_inputs("g", B, T, H, 13),
            "z": normal((B * S, T, 2 * H), 1),
            "spec": normal((B, 9, T, 2), 2), "pred": normal((B, 9, T, 2), 3),
            "src": normal((B, 500), 4), "est": normal((B, 500), 5)}


def test_mu_free_kl_and_covariance_parts():
    inputs = {**gauss_inputs("a", B, T, H, 12),
              **gauss_inputs("b", B, T, H, 11)}
    compare(lambda d: (jvv.mu_free_kl(gauss(d, "a", JGauss),
                                      gauss(d, "b", JGauss)),),
            lambda d: (tvv.mu_free_kl(gauss(d, "a", TGauss),
                                      gauss(d, "b", TGauss)),), inputs)
    compare(lambda d: jvv.mu_covariance_parts(d["a.mu_r"], d["a.mu_i"]),
            lambda d: tvv.mu_covariance_parts(d["a.mu_r"], d["a.mu_i"]),
            inputs)


VAE_CASES = {
    "vcae": ("VcaeLoss", (0.1,), {}),
    "vcae_prob_ri_corr_mi": ("VcaeLoss", (0.1,), dict(
        mi_weight=0.2, recon_loss_type="prob", prior_mode="ri_corr",
        pz_sigma=2.0, num_samples=S)),
    "regmiu_opt1": ("VcaeRegmiuLoss", (0.1,), dict(
        loss_opt=1, regmiu_w=0.5, recon_loss_weight=(1.0, 0.5, 0.2))),
    "regmiu_opt2_mi": ("VcaeRegmiuLoss", (0.1,), dict(
        loss_opt=2, regmiu_w=0.5, mi_weight=0.3, num_samples=S)),
    "dip": ("DipVaeLoss", (0.1,), dict(off_weight=0.5, diag_weight=0.5)),
    "dip_prob_mi": ("DipVaeLoss", (0.1,), dict(
        mi_weight=0.2, recon_loss_type="prob", num_samples=S,
        prior_mode="ri_corr", miu_sigma=0.5)),
}


@pytest.mark.parametrize("case", sorted(VAE_CASES))
def test_vae_variant_losses(case):
    name, args, kw = VAE_CASES[case]

    def run(mod, cls):
        loss = getattr(mod, name)(*args, **kw)
        return lambda d: loss(d["src"], d["est"], d["spec"], d["pred"],
                              gauss(d, "g", cls), d["z"])

    compare(run(jvv, JGauss), run(tvv, TGauss), vae_inputs())


@pytest.mark.parametrize("mi_weight", [0.0, 0.3])
def test_est_likelihood_loss(mi_weight):
    f = 9
    inputs = {**gauss_inputs("g", B, T, H, 14),
              **gauss_inputs("x", B * S, T, f, 6),
              "target": normal((B, f, T, 2), 7),
              "z": normal((B * S, T, 2 * H), 8)}
    warm = np.asarray([0.2, 0.6], np.float32)

    def run(mod, cls):
        loss = mod.EstLikelihoodVaeLoss(warm, 0.1, mi_weight=mi_weight,
                                        num_samples=S)
        assert loss.kl_weight_at(1) == pytest.approx(0.6)
        assert loss.kl_weight_at(5) == pytest.approx(0.1)

        def fn(d):
            g_x = cls(*(d[f"x.{k}"].reshape((B, S, T, f)) for k in FIELDS))
            return loss(g_x, d["target"], gauss(d, "g", cls), d["z"], 0.1)
        return fn

    compare(run(jvv, JGauss), run(tvv, TGauss), inputs)


def test_sampled_kl():
    inputs = {**gauss_inputs("a", B, T, H, 10),
              **gauss_inputs("b", B, T, H, 11),
              "z": normal((B * S, T, 2 * H), 9)}
    compare(lambda d: (jnv.sampled_kl(gauss(d, "a", JGauss),
                                      gauss(d, "b", JGauss), d["z"]),),
            lambda d: (tnv.sampled_kl(gauss(d, "a", TGauss),
                                      gauss(d, "b", TGauss), d["z"]),),
            inputs)


def nsvae_inputs():
    return {**gauss_inputs("c", B, T, H, 15), **gauss_inputs("n", B, T, H, 16),
            **gauss_inputs("s", B, T, H, 17),
            **gauss_inputs("nn", B, T, H, 18),
            "z_s": normal((B * 2, T, 2 * H), 19),
            "z_n": normal((B * 2, T, 2 * H), 20),
            "spec": normal((B, 9, T, 2), 8), "pred": normal((B, 9, T, 2), 9),
            "src": normal((B, 500), 10), "est": normal((B, 500), 11)}


def _gs(d, cls):
    return [gauss(d, k, cls) for k in ("c", "n", "s", "nn")]


@pytest.mark.parametrize("latent_num", [1, 2])
def test_nsvae_sampling_kl_loss(latent_num):
    kw = dict(encoder_channels=(1, 2, 2, 4, 4, 4, 4), latent_num=latent_num)

    def run(mod, cfg_cls, cls):
        loss = mod.NsvaeSamplingKlLoss(0.7, 0.0, 1.3, 0.0, cfg_cls(**kw))
        return lambda d: loss(*_gs(d, cls), d["z_s"], d["z_n"])

    compare(run(jnv, JaxConfig, JGauss), run(tnv, TorchConfig, TGauss),
            nsvae_inputs())


@pytest.mark.parametrize("latent_num", [1, 2])
def test_nsvae_with_decoder_recon_loss(latent_num):
    def run(mod, cls):
        loss = mod.NsvaeWithDecoderReconLoss(0.8, 1.2, 0.5, (1.0, 0.5, 0.2),
                                             latent_num)
        return lambda d: loss(*_gs(d, cls), d["pred"], d["spec"], d["src"],
                              d["est"])

    compare(run(jnv, JGauss), run(tnv, TGauss), nsvae_inputs())


def test_ete_with_latent_loss():
    def run(mod, cls):
        loss = mod.EteWithLatentLoss(0.1, (1.0, 1.0, 0.3), alpha=0.5)
        return lambda d: loss(*_gs(d, cls)[:3], d["pred"], d["spec"],
                              d["src"], d["est"])

    compare(run(jnv, JGauss), run(tnv, TGauss), nsvae_inputs())
