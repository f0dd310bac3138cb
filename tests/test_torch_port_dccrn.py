"""Port SupervisedDccrn / LegacyDccrn / VaeEncoder against the JAX models
on the CPU, from the same weights (see torch_port_util for the
tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.models.dccrn import LegacyDccrn as JaxLegacy
from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JaxSupervised
from idccrn_vae_tpu.models.vae import VaeEncoder as JaxVaeEncoder
from idccrn_vae_torch.models.dccrn import LegacyDccrn, SupervisedDccrn
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.vae import VaeEncoder
from torch_port_util import (
    NoiseStream,
    assert_close,
    configs,
    datanorm_stats,
    np_vars,
    patch_jax_noise,
    wav_batch,
)

N = 3200  # 0.2 s at 16 kHz -> 33 frames
SUPERVISED = dict(recon_type="mask", lstm_hidden=8)


def _jdn(dn):
    return None if dn is None else tuple(map(jnp.asarray, dn))


@pytest.mark.parametrize("compute,datanorm,return_latent,extra", [
    ("f32", False, False, {}),
    ("f32", True, True, {}),
    ("bf16", False, False, {}),
    ("bf16", True, False, {}),
    ("f32", False, True, {"recon_type": "real_imag", "resynthesis": True}),
    ("f32", True, False, {"causal": False}),
])
def test_supervised_dccrn_matches_jax(compute, datanorm, return_latent,
                                      extra):
    jc, tc = configs(compute=compute, **dict(SUPERVISED, **extra))
    dn = datanorm_stats(4) if datanorm else None
    ref_model = JaxSupervised(jc, _jdn(dn))
    variables = np_vars(ref_model.init(jax.random.PRNGKey(0)))
    model = load_jax_variables(
        SupervisedDccrn(tc, datanorm=dn, device="cpu"), variables)
    wav = wav_batch(1, 2, N)
    ref, _ = ref_model.apply(variables, jnp.asarray(wav), train=False,
                             return_latent=return_latent)
    with torch.no_grad():
        out = model(torch.from_numpy(wav), return_latent=return_latent)
    assert len(out) == len(ref) == (3 if return_latent else 2)
    # non-causal stages drop a frame each in the encoder and add it back
    # in the decoder
    assert out[0].shape == (2, (N // 100) * 100)
    assert out[1].shape == (2, 257, N // 100 + 1, 2)
    for o, r in zip(out, ref):
        assert o.dtype == torch.float32
        assert_close(o, r, compute)


def test_supervised_stft_clean_has_no_datanorm():
    jc, tc = configs(**SUPERVISED)
    dn = datanorm_stats(5)
    wav = wav_batch(2, 2, N)
    ref = JaxSupervised(jc, _jdn(dn)).stft_clean(jnp.asarray(wav))
    out = SupervisedDccrn(tc, datanorm=dn, device="cpu").stft_clean(
        torch.from_numpy(wav))
    assert_close(out, ref)


def test_legacy_dccrn_matches_jax():
    """Legacy pins (non-causal, mask, a real skip at every stage) hold
    whatever the config says; forward returns the waveform only."""
    jc, tc = configs(lstm_hidden=8, causal=True, recon_type="real_imag",
                     skip_mode="none", skip_to_use=(0,))
    ref_model = JaxLegacy(jc)
    variables = np_vars(ref_model.init(jax.random.PRNGKey(2)))
    model = load_jax_variables(LegacyDccrn(tc, device="cpu"), variables)
    assert not model.cfg.causal and model.cfg.recon_type == "mask"
    assert model.cfg.skip_to_use == tuple(range(tc.num_stages))
    wav = wav_batch(3, 2, N)
    ref, _ = ref_model.apply(variables, jnp.asarray(wav), train=False)
    with torch.no_grad():
        out = model(torch.from_numpy(wav))
    assert isinstance(out, torch.Tensor)
    assert_close(out, ref)


@pytest.mark.parametrize("model_cls,prefix", [
    (SupervisedDccrn, "std_DCCRN"),
    (LegacyDccrn, "DCCRN"),
])
def test_dccrn_state_names_and_dead_linear(model_cls, prefix):
    """State names carry the reference's prefix; a reference checkpoint's
    never-applied 1x1 `linear` conv is dropped on load."""
    _, tc = configs(**SUPERVISED)
    src = model_cls(tc, device="cpu",
                    generator=torch.Generator().manual_seed(9))
    sd = src.state_dict()
    assert all(k.startswith(prefix + ".") for k in sd)
    assert f"{prefix}.lstms.0.lstm_re.weight_hh_l1" in sd
    ckpt = dict(sd)
    ckpt[f"{prefix}.linear.weight"] = torch.zeros(1, 1, 1, 1)
    ckpt[f"{prefix}.linear.bias"] = torch.zeros(1)
    dst = model_cls(tc, device="cpu")
    dst.load_state_dict(ckpt)
    assert all(torch.equal(dst.state_dict()[k], v) for k, v in sd.items())


@pytest.mark.parametrize("compute,latent,datanorm,ns", [
    ("f32", "sliced", False, 1),
    ("f32", "sliced", True, 3),
    ("bf16", "sliced", False, 2),
    ("f32", "fc", False, 2),
    ("f32", "fc", True, 1),
])
def test_vae_encoder_matches_jax(compute, latent, datanorm, ns, monkeypatch):
    jc, tc = configs(compute=compute, latent=latent)
    dn = datanorm_stats(6) if datanorm else None
    ref_model = JaxVaeEncoder(jc, _jdn(dn))
    variables = np_vars(ref_model.init(jax.random.PRNGKey(4)))
    enc = load_jax_variables(VaeEncoder(tc, datanorm=dn, device="cpu"),
                             variables)
    assert enc.guard == ref_model.guard
    wav = wav_batch(4, 2, N)
    patch_jax_noise(monkeypatch, NoiseStream(8),
                    module="idccrn_vae_tpu.models.vae")
    ref, _ = ref_model.apply(variables, jnp.asarray(wav), train=False,
                             rng=jax.random.PRNGKey(1), num_samples=ns)
    noise = NoiseStream(8)(2, ns, N // 100 + 1, tc.zdim)
    with torch.no_grad():
        out = enc(torch.from_numpy(wav), num_samples=ns,
                  noise=tuple(torch.from_numpy(e) for e in noise))
    assert_close(out.stft_x, ref.stft_x)
    for s, r in zip(out.skips, ref.skips):
        assert_close(s, r, compute)
    for field in out.gauss._fields:
        assert_close(getattr(out.gauss, field), getattr(ref.gauss, field),
                     compute)
    assert out.z.shape == (2 * ns, N // 100 + 1, 2 * tc.zdim)
    assert_close(out.z, ref.z, compute)
