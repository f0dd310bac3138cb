"""The slice end to end: the port's `Enhancer` (`clean_direct`) against the
JAX `Enhancer` on the CPU, from the same weights and the same latent
draws (see torch_port_util for the tolerances)."""

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
    NoiseStream,
    assert_close,
    configs,
    np_vars,
    patch_jax_noise,
    patch_port_noise,
    wav_batch,
)

BUCKET_FRAMES = 10


def _pair(compute="f32", num_samples=1, sample_chunks=1):
    """(JAX Enhancer, port Enhancer) from one set of JAX weights."""
    jc, tc = configs(compute=compute)
    ev = np_vars(JaxEncoder(jc).init(jax.random.PRNGKey(0)))
    dv = np_vars(JaxDecoder(jc).init(jax.random.PRNGKey(1)))
    enc_state = load_jax_variables(NsvaeEncoder(tc, device="cpu"),
                                   ev).state_dict()
    dec_state = load_jax_variables(VaeDecoder(tc, device="cpu"),
                                   dv).state_dict()
    kw = dict(num_samples=num_samples, bucket_frames=BUCKET_FRAMES,
              sample_chunks=sample_chunks)
    ref = jenhance.Enhancer(jc, jc, ev, dv, **kw)
    port = tenhance.Enhancer(tc, tc, enc_state, dec_state, device="cpu", **kw)
    return ref, port


@pytest.mark.parametrize("compute,num_samples,sample_chunks", [
    ("f32", 1, 1),
    ("bf16", 1, 1),
    ("f32", 3, 1),   # the decoder's 'shared' skip path
    ("bf16", 3, 1),
    ("f32", 3, 3),   # three sequential decoder chunks of one sample
])
def test_enhancer_forward_matches_jax(compute, num_samples, sample_chunks,
                                      monkeypatch):
    ref, port = _pair(compute, num_samples, sample_chunks)
    b, n = 2, 4000  # 0.25 s -> 41 frames
    wav = wav_batch(1, b, n)
    patch_jax_noise(monkeypatch, NoiseStream(11))
    expect = ref.forward(ref.enc_vars, ref.dec_vars, None, jnp.asarray(wav),
                         jax.random.PRNGKey(0))
    noise = NoiseStream(11)(b, num_samples, n // 100 + 1, 4)
    out = port.forward(torch.from_numpy(wav),
                       noise=tuple(torch.from_numpy(e) for e in noise))
    assert out.shape == (b, n) and out.dtype == torch.float32
    assert_close(out, expect, compute)


def test_enhance_utterances_matches_jax(monkeypatch):
    """Mixed lengths, sorted and bucketed in batches of 3, so the two
    batches have different shapes (each JAX trace draws its noise once)
    and come back trimmed to their inputs' lengths."""
    ref, port = _pair()
    rng = np.random.default_rng(5)
    lengths = (3900, 1700, 6100, 2500, 5300)
    wavs = [(0.1 * rng.standard_normal(n)).astype(np.float32)
            for n in lengths]
    patch_jax_noise(monkeypatch, NoiseStream(21))
    patch_port_noise(monkeypatch, NoiseStream(21))
    expect = ref.enhance_utterances(wavs, batch_size=3)
    outs = port.enhance_utterances(wavs, batch_size=3)
    assert [len(o) for o in outs] == list(lengths)
    for o, e in zip(outs, expect):
        assert isinstance(o, np.ndarray) and o.dtype == np.float32
        assert_close(o, e)


def test_enhance_batch_stays_on_device_and_is_seeded():
    _, port = _pair()
    wav = wav_batch(2, 2, 2000)
    a = port.enhance_batch(wav)
    b = port.enhance_batch(torch.from_numpy(wav))
    c = port.enhance_batch(wav, port.new_generator(1))
    assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


@pytest.mark.parametrize("n", [0, 99, 100, 999, 1000, 48000, 48099])
def test_bucket_pad_length_matches_jax(n):
    for frames in (1, 10, 100):
        assert (tenhance.bucket_pad_length(n, 100, frames)
                == jenhance.bucket_pad_length(n, 100, frames))


def _invalid_enhancer(case):
    """Build the Enhancer of one invalid argument set (tiny geometry)."""
    _, dual = configs(latent_num=2, channel_mode="double")
    _, single = configs()
    enc = {c: NsvaeEncoder(c, device="cpu").state_dict()
           for c in (dual, single)}
    dec = VaeDecoder(single, device="cpu").state_dict()
    kw = dict(device="cpu", num_samples=1)
    if case == "dual_without_noise_decoder":
        return tenhance.Enhancer(dual, single, enc[dual], dec,
                                 latent_to_use=2, outtype="complex_mask",
                                 **kw)
    if case == "dual_with_single_latent_encoder":
        return tenhance.Enhancer(single, single, enc[single], dec, dec,
                                 latent_to_use=2, **kw)
    if case == "mask_with_one_latent":
        return tenhance.Enhancer(dual, single, enc[dual], dec, dec,
                                 outtype="complex_mask", **kw)
    if case == "unknown_outtype":
        return tenhance.Enhancer(dual, single, enc[dual], dec, dec,
                                 latent_to_use=2, outtype="wiener", **kw)
    if case == "latent_to_use_3":
        return tenhance.Enhancer(single, single, enc[single], dec,
                                 latent_to_use=3, **kw)
    if case == "sample_chunks":
        kw["num_samples"] = 3
        return tenhance.Enhancer(single, single, enc[single], dec,
                                 sample_chunks=2, **kw)
    raise AssertionError(case)


@pytest.mark.parametrize("case,error,match", [
    ("dual_without_noise_decoder", ValueError, "noise decoder weights"),
    ("dual_with_single_latent_encoder", ValueError, "dual-latent encoder"),
    ("mask_with_one_latent", ValueError, "latent_to_use=2"),
    ("unknown_outtype", ValueError, "unknown outtype"),
    ("latent_to_use_3", ValueError, "latent_to_use must be 1 or 2"),
    ("sample_chunks", ValueError, "sample_chunks"),
])
def test_unported_serving_modes_raise(case, error, match):
    """The serving validation that still applies: the dual-latent path
    needs a latent_num=2 encoder and noise decoder weights, the mask
    out-types need latent_to_use=2, and sample_chunks must divide
    num_samples."""
    with pytest.raises(error, match=match):
        _invalid_enhancer(case)


def test_int8_enhancer_serves():
    """compute='int8' (once refused here) builds and serves: finite
    output of the input's length; tests/test_torch_port_int8.py holds
    it against JAX."""
    _, int8 = configs(compute="int8", quant_min_ch=2)
    enh = tenhance.Enhancer(int8, int8,
                            NsvaeEncoder(int8, device="cpu").state_dict(),
                            VaeDecoder(int8, device="cpu").state_dict(),
                            num_samples=1, device="cpu")
    out = enh.enhance_batch(wav_batch(3, 2, 2000))
    assert out.shape == (2, 2000) and bool(torch.isfinite(out).all())
