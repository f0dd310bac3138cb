"""Dual-latent serving: the port's `combine_outputs`, `Enhancer` with
`latent_to_use=2` and `encode_latents` against the JAX package on the
CPU, from the same weights and the same latent draws (see
torch_port_util for the tolerances)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.eval import enhance as jenhance
from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_torch.eval import enhance as tenhance
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from torch_port_util import (
    BF16_REL,
    NoiseStream,
    assert_close,
    configs,
    np_vars,
    patch_jax_noise,
    to_np,
    wav_batch,
)

BUCKET_FRAMES = 10
MASKS = ("real_imag_mask", "complex_mask", "phase_mask")
CHANNELS = {
    "normal": {},
    "double": {"channel_mode": "double"},
    # only the stages feeding decoder skips 0, 2 and 4 are doubled
    "adapt": {"channel_mode": "adapt", "skip_to_use": (0, 2, 4)},
}


@pytest.mark.parametrize("outtype", ("clean_direct",) + MASKS)
@pytest.mark.parametrize("num_samples", [1, 3])
def test_combine_outputs_matches_jax(outtype, num_samples):
    rng = np.random.default_rng(num_samples)
    b, f, t = 2, 17, 9
    speech, noise = (rng.standard_normal((b * num_samples, f, t, 2))
                     .astype(np.float32) for _ in range(2))
    noisy = rng.standard_normal((b, f, t, 2)).astype(np.float32)
    ref = jenhance.combine_outputs(outtype, jnp.asarray(speech),
                                   jnp.asarray(noise), jnp.asarray(noisy),
                                   num_samples)
    out = tenhance.combine_outputs(outtype, torch.from_numpy(speech),
                                   torch.from_numpy(noise),
                                   torch.from_numpy(noisy), num_samples)
    assert out.shape == (b, f, t, 2) and out.dtype == torch.float32
    assert_close(out, ref)


def test_combine_outputs_rejects_unknown_outtype():
    x = torch.zeros(1, 3, 2, 2)
    with pytest.raises(ValueError, match="unknown outtype"):
        tenhance.combine_outputs("wiener", x, x, x, 1)


def _dual_pair(channels="double", compute="f32", num_samples=1,
               sample_chunks=1, outtype="complex_mask"):
    """(JAX Enhancer, port Enhancer), latent_to_use=2, from one set of
    JAX weights: dual-latent encoder, speech and noise decoders."""
    extra = dict(CHANNELS[channels], compute=compute)
    jc, tc = configs(latent_num=2, **extra)
    jdc, tdc = (dataclasses.replace(c, latent_num=1, channel_mode="normal")
                for c in (jc, tc))
    ev = np_vars(JaxEncoder(jc).init(jax.random.PRNGKey(0)))
    dv = np_vars(JaxDecoder(jdc).init(jax.random.PRNGKey(1)))
    nv = np_vars(JaxDecoder(jdc).init(jax.random.PRNGKey(2)))
    enc_state = load_jax_variables(NsvaeEncoder(tc, device="cpu"),
                                   ev).state_dict()
    dec_state, noise_state = (
        load_jax_variables(VaeDecoder(tdc, device="cpu"), v).state_dict()
        for v in (dv, nv))
    kw = dict(num_samples=num_samples, bucket_frames=BUCKET_FRAMES,
              sample_chunks=sample_chunks, outtype=outtype, latent_to_use=2)
    ref = jenhance.Enhancer(jc, jdc, ev, dv, nv, **kw)
    port = tenhance.Enhancer(tc, tdc, enc_state, dec_state, noise_state,
                             device="cpu", **kw)
    return ref, port


def _forward_both(ref, port, monkeypatch, b=2, n=4000, seed=11):
    wav = wav_batch(seed, b, n)
    ns = ref.num_samples
    patch_jax_noise(monkeypatch, NoiseStream(seed))
    expect = ref.forward(ref.enc_vars, ref.dec_vars, ref.noise_dec_vars,
                         jnp.asarray(wav), jax.random.PRNGKey(0))
    stream = NoiseStream(seed)
    eps = [tuple(torch.from_numpy(e) for e in stream(b, ns, n // 100 + 1, 4))
           for _ in range(2)]  # speech latent first, as the JAX encoder
    out = port.forward(torch.from_numpy(wav), noise=eps[0], noise_n=eps[1])
    assert out.shape == (b, n) and out.dtype == torch.float32
    return out, expect


@pytest.mark.parametrize("channels", list(CHANNELS))
@pytest.mark.parametrize("outtype", ("clean_direct",) + MASKS)
@pytest.mark.parametrize("num_samples,sample_chunks", [(2, 1), (2, 2)])
def test_dual_enhancer_matches_jax(channels, outtype, num_samples,
                                   sample_chunks, monkeypatch):
    ref, port = _dual_pair(channels, "f32", num_samples, sample_chunks,
                           outtype)
    assert (port.noise_decoder is not None) == (ref.noise_decoder is not None)
    out, expect = _forward_both(ref, port, monkeypatch)
    assert_close(out, expect)


def _capture_combine(monkeypatch, module, calls):
    """Record the spectra each side hands to its combine_outputs."""
    original = module.combine_outputs

    def recording(outtype, speech, noise, noisy, num_samples):
        calls.append((speech, noise))
        return original(outtype, speech, noise, noisy, num_samples)

    monkeypatch.setattr(module, "combine_outputs", recording)


@pytest.mark.parametrize("outtype", ("clean_direct",) + MASKS)
def test_dual_enhancer_bf16_matches_jax(outtype, monkeypatch):
    """bf16, with BF16_REL of torch_port_util. clean_direct (the speech
    decoder alone) is held end to end within BF16_REL of max |ref|.

    The masks combine the two decoders' spectra, which match within
    BF16_REL of max |ref|; the combination itself is float32 (held at
    1e-4 above). End to end, the bounded masks (real_imag_mask in
    [0, 1], phase_mask in [-1, 1]) scale the noisy input by a factor
    whose bf16 error is at most the mask's range in any bin, so their
    output is held within BF16_REL of the noisy input's max.
    complex_mask's S/(S+N) has no bound where S is close to -N: a few
    bf16 ulps in S and N change such a bin arbitrarily, so only its
    spectra are held."""
    ref, port = _dual_pair("double", "bf16", 1, 1, outtype)
    ref_calls, port_calls = [], []
    _capture_combine(monkeypatch, jenhance, ref_calls)
    _capture_combine(monkeypatch, tenhance, port_calls)
    out, expect = _forward_both(ref, port, monkeypatch)
    if outtype == "clean_direct":
        assert ref_calls == port_calls == []
        assert_close(out, expect, "bf16")
        return
    assert len(ref_calls) == len(port_calls) == 1
    for o, r in zip(port_calls[0], ref_calls[0]):
        assert_close(o, r, "bf16")
    if outtype != "complex_mask":
        noisy_max = np.abs(wav_batch(11, 2, 4000)).max()
        err = np.abs(to_np(out) - to_np(expect)).max()
        assert err <= BF16_REL * noisy_max, (err, noisy_max)


@pytest.mark.parametrize("latent_num", [1, 2])
def test_encode_latents_matches_jax(latent_num):
    """Posterior means of mixed-length utterances, batched in buckets and
    trimmed to each utterance's real frame count."""
    extra = {} if latent_num == 1 else {"channel_mode": "double"}
    jc, tc = configs(latent_num=latent_num, **extra)
    jdc, tdc = (dataclasses.replace(c, latent_num=1, channel_mode="normal")
                for c in (jc, tc))
    ev = np_vars(JaxEncoder(jc).init(jax.random.PRNGKey(3)))
    dv = np_vars(JaxDecoder(jdc).init(jax.random.PRNGKey(4)))
    ref = jenhance.Enhancer(jc, jdc, ev, dv, num_samples=1,
                            bucket_frames=BUCKET_FRAMES)
    port = tenhance.Enhancer(
        tc, tdc,
        load_jax_variables(NsvaeEncoder(tc, device="cpu"), ev).state_dict(),
        load_jax_variables(VaeDecoder(tdc, device="cpu"), dv).state_dict(),
        num_samples=1, bucket_frames=BUCKET_FRAMES, device="cpu")
    rng = np.random.default_rng(7)
    lengths = (2900, 1200, 4100, 1900)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]
    ref_s, ref_n = ref.encode_latents(wavs, batch_size=3)
    out_s, out_n = port.encode_latents(wavs, batch_size=3)
    assert len(out_s) == len(lengths)
    assert len(out_n) == len(ref_n) == (len(lengths) if latent_num == 2 else 0)
    # both sides list the utterances in the order they batch them:
    # sorted by length
    by_length = sorted(lengths) * 2
    for o, r, n in zip(out_s + out_n, ref_s + ref_n, by_length):
        assert isinstance(o, np.ndarray)
        assert o.shape == (n // 100 + 1, tc.zdim, 2)
        assert_close(o, r)
