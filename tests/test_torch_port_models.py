"""Port NsvaeEncoder / VaeDecoder against the JAX models on the CPU, from
the same weights (see torch_port_util for the tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.modules import ComplexBatchNorm
from idccrn_vae_torch.models.nsvae import NsvaeEncoder, split_noisy_skips
from idccrn_vae_torch.models.vae import VaeDecoder
from torch_port_util import (
    NoiseStream,
    assert_close,
    configs,
    np_vars,
    patch_jax_noise,
    wav_batch,
)

N = 3200  # 0.2 s at 16 kHz -> 33 frames


@pytest.mark.parametrize("compute,extra", [
    ("f32", {}),
    ("bf16", {}),
    ("f32", {"latent": "fc"}),
    ("f32", {"channel_mode": "double", "latent_num": 2}),
])
def test_nsvae_encoder_matches_jax(compute, extra, monkeypatch):
    jc, tc = configs(compute=compute, **extra)
    variables = np_vars(JaxEncoder(jc).init(jax.random.PRNGKey(0)))
    enc = load_jax_variables(NsvaeEncoder(tc, device="cpu"), variables)
    wav = wav_batch(0, 2, N)
    ns = 2
    patch_jax_noise(monkeypatch, NoiseStream(7))
    ref, _ = JaxEncoder(jc).apply(variables, jnp.asarray(wav), train=False,
                                  rng=jax.random.PRNGKey(1), num_samples=ns)
    t_frames = N // 100 + 1
    noise = NoiseStream(7)(2, ns, t_frames, tc.zdim)
    with torch.no_grad():
        out = enc(torch.from_numpy(wav), num_samples=ns,
                  noise=tuple(torch.from_numpy(e) for e in noise))
    assert_close(out.stft_x, ref.stft_x)
    assert len(out.skips) == len(ref.skips) == tc.num_stages
    for s, r in zip(out.skips, ref.skips):
        assert s.dtype == tc.compute_dtype
        assert_close(s, r, compute)
    for g, r in [(out.gauss_speech, ref.gauss_speech),
                 (out.gauss_noise, ref.gauss_noise)][: tc.latent_num]:
        for field in g._fields:
            assert_close(getattr(g, field), getattr(r, field), compute)
    assert out.z_speech.shape == (2 * ns, t_frames, 2 * tc.zdim)
    assert_close(out.z_speech, ref.z_speech, compute)
    if tc.latent_num == 2:
        assert out.z_noise.shape == out.z_speech.shape
        speech = split_noisy_skips(out.skips, tc, "speech")
        assert [s.shape[-1] for s in speech] == [
            2 * c for c in tc.encoder_channels[1:]]


@pytest.mark.parametrize("compute,ns,extra", [
    ("f32", 1, {}),
    ("bf16", 1, {}),
    ("f32", 3, {}),
    ("bf16", 3, {}),
    ("f32", 2, {"skip_mode": "zero"}),
    ("f32", 1, {"skip_mode": "none", "recon_type": "mask"}),
    ("f32", 2, {"skip_mode": "runtime", "causal": False,
                "skip_to_use": (1, 4)}),
])
def test_vae_decoder_matches_jax(compute, ns, extra):
    jc, tc = configs(compute=compute, **extra)
    rng = np.random.default_rng(3)
    variables = np_vars(JaxDecoder(jc).init(jax.random.PRNGKey(2)))
    datanorm = None
    if tc.recon_type == "mask":
        datanorm = (rng.standard_normal((257, 2)).astype(np.float32),
                    1 + rng.random((257, 2)).astype(np.float32))
    dec = load_jax_variables(
        VaeDecoder(tc, datanorm=datanorm, device="cpu"), variables)
    b, t = 2, 21
    f_sizes = (129, 65, 33, 17, 9, 5)
    stft_x = rng.standard_normal((b, 257, t, 2)).astype(np.float32)
    z = rng.standard_normal((b * ns, t, 2 * tc.zdim)).astype(np.float32)
    skips = [(0.5 * rng.standard_normal((b, f, t, 2 * c))).astype(np.float32)
             for f, c in zip(f_sizes, tc.encoder_channels[1:])]
    pad_mode = "zero" if tc.skip_mode == "runtime" else "sig"
    jdn = None if datanorm is None else tuple(map(jnp.asarray, datanorm))
    cast = lambda a: jnp.asarray(a, jc.compute_dtype)
    (ref_sig, ref_pred), _ = JaxDecoder(jc, datanorm=jdn).apply(
        variables, jnp.asarray(stft_x), jnp.asarray(z),
        [cast(s) for s in skips], train=False, num_samples=ns,
        pad_mode=pad_mode)
    with torch.no_grad():
        sig, pred = dec(torch.from_numpy(stft_x), torch.from_numpy(z),
                        [torch.from_numpy(s).to(tc.compute_dtype)
                         for s in skips], num_samples=ns, pad_mode=pad_mode)
    # a non-causal decoder stage adds one frame (its encoder took one)
    t_out = t if tc.causal else t + tc.num_stages
    assert sig.shape == (b * ns, (t_out - 1) * 100)
    assert sig.dtype == pred.dtype == torch.float32
    assert_close(pred, ref_pred, compute)
    assert_close(sig, ref_sig, compute)


def test_modules_refuse_train_mode_and_int8():
    """Train mode runs (held against JAX in test_torch_port_train_ops.py
    and test_torch_port_trainers.py); int8 modules build, and quantize
    in eval mode only (the JAX package's `not train`): a train-mode int8
    forward is the bf16 one."""
    _, tc = configs()
    enc = NsvaeEncoder(tc, device="cpu").train()
    out = enc(torch.randn(2, 1600))
    assert out.gauss_speech.mu_r.requires_grad
    assert all(m.count == 1 for m in enc.modules()
               if isinstance(m, ComplexBatchNorm))
    wav = torch.randn(2, 1600)
    mus = {}
    for compute in ("bf16", "int8"):
        _, cfg = configs(compute=compute, quant_min_ch=2)
        enc = NsvaeEncoder(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(1))
        for train in (True, False):
            with torch.no_grad():
                mus[compute, train] = enc.train(train)(
                    wav, num_samples=1).gauss_speech.mu_r
    assert torch.equal(mus["int8", True], mus["bf16", True])
    assert not torch.equal(mus["int8", False], mus["bf16", False])


def test_seeded_init_is_deterministic_and_device_independent():
    _, tc = configs()
    a = NsvaeEncoder(tc, device="cpu",
                     generator=torch.Generator().manual_seed(3)).state_dict()
    b = NsvaeEncoder(tc, device="cpu",
                     generator=torch.Generator().manual_seed(3)).state_dict()
    c = NsvaeEncoder(tc, device="cpu",
                     generator=torch.Generator().manual_seed(4)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    assert a["encoders.0.bn.Vrr"].shape == (1, 2, 1, 1)
    assert a["encoders.0.prelu.weight"].item() == pytest.approx(0.25)
