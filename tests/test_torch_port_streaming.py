"""The port's `StreamingEnhancer` against the JAX streaming engine on the
CPU, from the same weights: the whole stream and the carried state after
every chunk (f32 atol/rtol 1e-4, see torch_port_util)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.eval.streaming import StreamingEnhancer as JaxStreamer
from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JaxSupervised
from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_torch.eval.streaming import StreamingEnhancer, StreamState
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from torch_port_util import assert_close, configs, datanorm_stats, np_vars

B = 2
BASE = dict(causal=True, recon_type="mask")
CASES = {
    "normal": ({}, {}),
    "double": ({"latent_num": 2, "channel_mode": "double"}, {}),
    "zero_skip": ({}, {"skip_mode": "zero"}),
    "fc_latent": ({"latent": "fc"}, {}),
    "real_imag": ({"recon_type": "real_imag"},
                  {"recon_type": "real_imag"}),
}


def _wav(n, seed, zero_head=True):
    x = (0.1 * np.random.default_rng(seed).standard_normal((B, n))).astype(
        np.float32)
    if zero_head:
        x[:, :400] = 0.0
    return x


def _nsvae_pair(case, chunk_frames, compute="f32"):
    enc_extra, dec_extra = CASES[case]
    jc, tc = configs(compute=compute, **dict(BASE, **enc_extra))
    jdc, tdc = configs(compute=compute, **dict(BASE, **dict(
        {k: v for k, v in enc_extra.items()
         if k not in ("latent_num", "channel_mode", "latent")},
        **dec_extra)))
    ev = np_vars(JaxEncoder(jc).init(jax.random.PRNGKey(0)))
    dv = np_vars(JaxDecoder(jdc).init(jax.random.PRNGKey(1)))
    enc = load_jax_variables(NsvaeEncoder(tc, device="cpu"), ev).state_dict()
    dec = load_jax_variables(VaeDecoder(tdc, device="cpu"), dv).state_dict()
    ref = JaxStreamer(jc, jdc, ev, dv, chunk_frames=chunk_frames)
    port = StreamingEnhancer(tc, tdc, enc, dec, chunk_frames=chunk_frames,
                             device="cpu")
    return ref, port


def _supervised_pair(datanorm, chunk_frames):
    jc, tc = configs(**dict(BASE, lstm_hidden=4))
    dn = datanorm_stats(8) if datanorm else None
    v = np_vars(JaxSupervised(jc).init(jax.random.PRNGKey(5)))
    state = load_jax_variables(SupervisedDccrn(tc, device="cpu"),
                               v).state_dict()
    ref = JaxStreamer(jc, jc, v, v, chunk_frames=chunk_frames,
                      model="supervised", datanorm=dn)
    port = StreamingEnhancer(tc, tc, state, None, chunk_frames=chunk_frames,
                             model="supervised", datanorm=dn, device="cpu")
    return ref, port


def _pair(case, chunk_frames=10):
    if case.startswith("supervised"):
        return _supervised_pair(case.endswith("datanorm"), chunk_frames)
    return _nsvae_pair(case, chunk_frames)


def _leaves(state):
    """StreamState -> flat list of arrays, in field order."""
    out = []
    for field in state:
        if isinstance(field, list):
            for item in field:
                out.extend(item if isinstance(item, tuple) else (item,))
        else:
            out.append(field)
    return out


ALL_CASES = list(CASES) + ["supervised", "supervised_datanorm"]


@pytest.mark.parametrize("case", ALL_CASES)
def test_stream_matches_jax_chunk_by_chunk(case):
    """Every chunk's output and every carried state leaf, then the whole
    stream() output."""
    ref, port = _pair(case)
    wav = _wav(3000, seed=3, zero_head=False)
    m = port.chunk_samples
    js, ts = ref.init_state(B), port.init_state(B)
    assert isinstance(ts, StreamState)
    for k in range(wav.shape[1] // m):
        chunk = wav[:, k * m:(k + 1) * m]
        jout, js = ref.process_chunk(js, chunk)
        tout, ts = port.process_chunk(ts, chunk)
        assert tout.shape == (B, m)
        assert_close(tout, jout)
        jl, tl = _leaves(js), _leaves(ts)
        assert len(jl) == len(tl)
        for t, j in zip(tl, jl):
            assert_close(t, j)
    assert_close(port.stream(wav), ref.stream(wav))


@pytest.mark.parametrize("case", ["normal", "supervised"])
def test_stream_is_chunk_size_invariant(case):
    """8-frame chunks against 40-frame chunks on the port, and against
    the JAX engine at 40."""
    wav = _wav(4000, seed=0)
    ref, small = _pair(case, chunk_frames=8)
    big = _pair(case, chunk_frames=40)[1]
    out_small = small.stream(wav)
    out_big = big.stream(wav)
    assert out_small.shape == (B, 4000)
    assert_close(out_small, out_big)
    assert_close(out_big, _pair(case, chunk_frames=40)[0].stream(wav))


def test_stream_pads_final_partial_chunk():
    """The last L % chunk_samples samples are zero-padded, processed and
    trimmed: the output has the input's length, and its covered prefix
    equals a run on the exact-multiple prefix."""
    ref, port = _pair("normal")
    wav = _wav(3640, seed=8)
    out = port.stream(wav)
    assert out.shape == wav.shape
    assert_close(out, ref.stream(wav))
    assert_close(out[:, :3000], port.stream(wav[:, :3000]))


def test_streamer_validates_its_arguments():
    _, tc = configs(**BASE)
    enc = NsvaeEncoder(tc, device="cpu").state_dict()
    dec = VaeDecoder(tc, device="cpu").state_dict()
    noncausal = dataclasses.replace(tc, causal=False)
    with pytest.raises(ValueError, match="causal"):
        StreamingEnhancer(noncausal, tc, enc, dec, device="cpu")
    with pytest.raises(ValueError, match="model"):
        StreamingEnhancer(tc, tc, enc, dec, model="legacy", device="cpu")
    with pytest.raises(ValueError, match="dec_state"):
        StreamingEnhancer(tc, tc, enc, None, device="cpu")
    streamer = StreamingEnhancer(tc, tc, enc, dec, chunk_frames=5,
                                 device="cpu")
    with pytest.raises(ValueError, match="500"):
        streamer.process_chunk(streamer.init_state(1), torch.zeros(1, 400))
