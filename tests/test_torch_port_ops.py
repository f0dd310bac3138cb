"""Port ops against their JAX counterparts on the CPU (see torch_port_util
for the tolerances)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.models import modules as jmod
from idccrn_vae_tpu.models import nsvae as jnsvae
from idccrn_vae_tpu.models import reparam as jrep
from idccrn_vae_tpu.ops import batchnorm as jbn
from idccrn_vae_tpu.ops import conv as jconv
from idccrn_vae_tpu.ops import dense as jdense
from idccrn_vae_torch.models import modules as tmod
from idccrn_vae_torch.models import nsvae as tnsvae
from idccrn_vae_torch.models import reparam as trep
from idccrn_vae_torch.ops import batchnorm as tbn
from idccrn_vae_torch.ops import conv as tconv
from idccrn_vae_torch.ops import dense as tdense
from idccrn_vae_torch.ops import lstm as tlstm
from idccrn_vae_torch.ops import stft as tstft
from torch_port_util import assert_close, configs

# the JAX ops package re-exports functions named like these submodules
jlstm = importlib.import_module("idccrn_vae_tpu.ops.lstm")
jstft = importlib.import_module("idccrn_vae_tpu.ops.stft")

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------- stft


@pytest.mark.parametrize("n", [1600, 1650])
def test_stft_matches_jax(n):
    wav = _rand(np.random.default_rng(0), 2, n)
    ref = jstft.stft(jnp.asarray(wav), 64, 16, 48)
    out = tstft.stft(_t(wav), 64, 16, 48)
    assert_close(out, ref)
    assert_close(tstft.stft(_t(wav[0]), 64, 16, 48), ref[0])


@pytest.mark.parametrize("extra_hops", [-3, 0, 5])
def test_istft_matches_jax(extra_hops):
    """extra_hops > 0 asks for a length past the frames' coverage, where
    the envelope is 0 and both sides must give zeros, not NaN."""
    rng = np.random.default_rng(1)
    spec = _rand(rng, 2, 33, 21, 2)
    length = 20 * 16 + extra_hops * 16
    ref = jstft.istft(jnp.asarray(spec), 64, 16, 48, length=length)
    out = tstft.istft(_t(spec), 64, 16, 48, length=length)
    assert_close(out, ref)
    if extra_hops > 0:
        assert np.all(out[:, -16:].numpy() == 0.0)
    assert_close(tstft.istft(_t(spec), 64, 16, 48),
                 jstft.istft(jnp.asarray(spec), 64, 16, 48))


def test_stft_istft_roundtrip_default_geometry():
    wav = _rand(np.random.default_rng(2), 2, 4800)
    spec = tstft.stft(_t(wav))
    assert spec.shape == (2, 257, 49, 2)
    np.testing.assert_allclose(tstft.istft(spec).numpy(), wav, atol=1e-5)


# ---------------------------------------------------------------- conv


def _conv_params(rng, cin, cout, kh=5, kw=2):
    return {k: _rand(rng, kh, kw, cin, cout, scale=0.3) for k in ("wr", "wi")} | {
        k: _rand(rng, cout, scale=0.1) for k in ("br", "bi")}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_complex_conv2d_matches_jax(causal, compute):
    rng = np.random.default_rng(3)
    cin, cout = 3, 5
    x = _rand(rng, 2, 17, 9, 2 * cin)
    p = _conv_params(rng, cin, cout)
    jdt, tdt = DTYPES[compute]
    ref = jconv.complex_conv2d(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               (2, 1), (2, 1), causal=causal,
                               compute_dtype=jdt)
    perm = (3, 2, 0, 1)
    out = tconv.complex_conv2d(_t(x), _t(p["wr"].transpose(perm)),
                               _t(p["wi"].transpose(perm)), _t(p["br"]),
                               _t(p["bi"]), (2, 1), (2, 1), causal=causal,
                               compute_dtype=tdt)
    assert out.dtype == tdt
    assert_close(out, ref, compute)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_complex_conv_transpose2d_matches_jax(causal, compute):
    rng = np.random.default_rng(4)
    cin, cout = 3, 5
    x = _rand(rng, 2, 9, 7, 2 * cin)
    p = _conv_params(rng, cin, cout)
    jdt, tdt = DTYPES[compute]
    ref = jconv.complex_conv_transpose2d(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), (2, 1), (2, 0),
        causal=causal, compute_dtype=jdt)
    perm = (2, 3, 0, 1)
    out = tconv.complex_conv_transpose2d(
        _t(x), _t(p["wr"].transpose(perm)), _t(p["wi"].transpose(perm)),
        _t(p["br"]), _t(p["bi"]), (2, 1), (2, 0), causal=causal,
        compute_dtype=tdt)
    assert out.shape == (2, 17, 7 if causal else 8, 2 * cout)
    assert_close(out, ref, compute)


# ---------------------------------------------------------------- batch norm


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_complex_batch_norm_eval_matches_jax(compute):
    rng = np.random.default_rng(5)
    c = 6
    jdt, tdt = DTYPES[compute]
    x = _rand(rng, 2, 7, 5, 2 * c)
    params = {"gamma_rr": 1 + _rand(rng, c, scale=0.2),
              "gamma_ri": _rand(rng, c),
              "gamma_ii": 1 + _rand(rng, c, scale=0.2),
              "beta_r": _rand(rng, c, scale=0.1),
              "beta_i": _rand(rng, c, scale=0.1)}
    stats = {"mean_r": _rand(rng, c, scale=0.3),
             "mean_i": _rand(rng, c, scale=0.3),
             "Vrr": (1 + 0.5 * rng.random(c)).astype(np.float32),
             "Vri": _rand(rng, c, scale=0.2),
             "Vii": (1 + 0.5 * rng.random(c)).astype(np.float32)}
    ref, _ = jbn.complex_batch_norm(
        jnp.asarray(x, jdt), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, stats) | {"count": jnp.ones((), jnp.int32)},
        train=False)
    tstats = {k: _t(v).reshape(1, c, 1, 1) for k, v in stats.items()}
    out = tbn.complex_batch_norm(_t(x).to(tdt),
                                 {k: _t(v) for k, v in params.items()},
                                 tstats)
    assert out.dtype == tdt
    assert_close(out, ref, compute)


# ---------------------------------------------------------------- dense


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_complex_dense_matches_jax(compute):
    rng = np.random.default_rng(6)
    jdt, tdt = DTYPES[compute]
    x = _rand(rng, 2, 5, 2 * 4)
    p = {"wr": _rand(rng, 4, 7), "wi": _rand(rng, 4, 7),
         "br": _rand(rng, 7), "bi": _rand(rng, 7)}
    ref = jdense.complex_dense(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                               compute_dtype=None if compute == "f32" else jdt)
    out = tdense.complex_dense(_t(x), _t(p["wr"].T), _t(p["wi"].T),
                               _t(p["br"]), _t(p["bi"]),
                               None if compute == "f32" else tdt)
    assert out.dtype == torch.float32
    assert_close(out, ref, "f32")


# ---------------------------------------------------------------- lstm


def _lstm_layers(rng, n_in, hid, layers=2):
    return [{"w_ih": _rand(rng, n_in if k == 0 else hid, 4 * hid, scale=0.3),
             "w_hh": _rand(rng, hid, 4 * hid, scale=0.3),
             "b_ih": _rand(rng, 4 * hid, scale=0.1),
             "b_hh": _rand(rng, 4 * hid, scale=0.1)} for k in range(layers)]


def _torch_layers(layers):
    return [{k: _t(v.T) if k.startswith("w") else _t(v)
             for k, v in layer.items()} for layer in layers]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_complex_lstm_matches_jax(with_state, compute):
    rng = np.random.default_rng(7)
    b, t, n_in, hid = 2, 6, 5, 3
    jdt, tdt = DTYPES[compute]
    x = _rand(rng, b, t, 2 * n_in)
    p = {"re": _lstm_layers(rng, n_in, hid), "im": _lstm_layers(rng, n_in, hid)}
    state = None
    if with_state:
        state = [(_rand(rng, 2, 2 * b, hid, scale=0.5),
                  _rand(rng, 2, 2 * b, hid, scale=0.5)) for _ in range(2)]
    cdt_j = None if compute == "f32" else jdt
    cdt_t = None if compute == "f32" else tdt
    ref, ref_state = jlstm.complex_lstm(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), compute_dtype=cdt_j,
        state=None if state is None else jax.tree.map(jnp.asarray, state),
        return_state=True)
    out, out_state = tlstm.complex_lstm(
        _t(x), {k: _torch_layers(v) for k, v in p.items()},
        compute_dtype=cdt_t,
        state=None if state is None else [(_t(h), _t(c)) for h, c in state],
        return_state=True)
    assert out.dtype == torch.float32 and out.shape == (b, t, 2 * hid)
    assert_close(out, ref, compute)
    for (h, c), (jh, jc) in zip(out_state, ref_state):
        assert h.dtype == tdt and c.dtype == torch.float32
        assert_close(h, jh, compute)
        assert_close(c, jc, compute)


def test_real_lstm_matches_jax():
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 5, 4)
    layers = _lstm_layers(rng, 4, 3)
    ref = jlstm.lstm(jnp.asarray(x), jax.tree.map(jnp.asarray, layers))
    assert_close(tlstm.lstm(_t(x), _torch_layers(layers)), ref)


# ---------------------------------------------------------------- modules


def test_prelu_keeps_dtype_and_matches_jax():
    x = _rand(np.random.default_rng(9), 3, 4, 6)
    alpha = np.float32(0.2)
    for jdt, tdt in DTYPES.values():
        ref = jmod.prelu(jnp.asarray(x, jdt), jnp.asarray(alpha))
        out = tmod.prelu(_t(x).to(tdt), torch.tensor([alpha]))
        assert out.dtype == tdt
        np.testing.assert_array_equal(out.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))


def test_flatten_unflatten_match_jax():
    x = _rand(np.random.default_rng(10), 2, 5, 3, 8)
    ref = jmod.flatten_bottleneck(jnp.asarray(x))
    flat = tmod.flatten_bottleneck(_t(x))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref))
    back = tmod.unflatten_bottleneck(flat, 4, 5)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmod.unflatten_bottleneck(ref, 4, 5)))
    np.testing.assert_array_equal(back.numpy(), x)


def test_cpack_concat_datanorm_mask_match_jax():
    rng = np.random.default_rng(11)
    a, b = _rand(rng, 2, 3, 4, 6), _rand(rng, 2, 3, 4, 4)
    np.testing.assert_array_equal(
        tmod.cpack_concat(_t(a), _t(b)).numpy(),
        np.asarray(jmod.cpack_concat(jnp.asarray(a), jnp.asarray(b))))
    spec = _rand(rng, 2, 9, 4, 2)
    mean, std = _rand(rng, 9, 2), 1 + rng.random((9, 2)).astype(np.float32)
    assert_close(tmod.apply_datanorm(_t(spec), _t(mean), _t(std)),
                 jmod.apply_datanorm(jnp.asarray(spec), jnp.asarray(mean),
                                     jnp.asarray(std)))
    assert_close(tmod.undo_datanorm(_t(spec), _t(mean), _t(std)),
                 jmod.undo_datanorm(jnp.asarray(spec), jnp.asarray(mean),
                                    jnp.asarray(std)))
    mask = _rand(rng, 2, 9, 4, 2)
    assert_close(tmod.mask_reconstruct(_t(mask), _t(spec)),
                 jmod.mask_reconstruct(jnp.asarray(mask), jnp.asarray(spec)))


# ---------------------------------------------------------------- latents


@pytest.mark.parametrize("guard", ["eps", "clamp"])
def test_reparameterize_matches_jax(guard):
    rng = np.random.default_rng(12)
    b, t, h, s = 2, 5, 3, 4
    # wide log_sigma and large deltas exercise the clamp and projection
    fields = dict(mu_r=_rand(rng, b, t, h), mu_i=_rand(rng, b, t, h),
                  log_sigma=_rand(rng, b, t, h, scale=8.0),
                  delta_r=_rand(rng, b, t, h, scale=2.0),
                  delta_i=_rand(rng, b, t, h, scale=2.0))
    er, ei = _rand(rng, b, s, t, h), _rand(rng, b, s, t, h)
    ref = jrep.reparameterize(
        None, jrep.CGauss(**{k: jnp.asarray(v) for k, v in fields.items()}),
        s, guard=guard, noise=(jnp.asarray(er), jnp.asarray(ei)))
    out = trep.reparameterize(
        trep.CGauss(**{k: _t(v) for k, v in fields.items()}), s, guard=guard,
        noise=(_t(er), _t(ei)))
    assert out.shape == (b * s, t, 2 * h)
    ref, out = np.asarray(ref), out.numpy()
    finite = np.isfinite(ref)
    np.testing.assert_array_equal(np.isfinite(out), finite)
    np.testing.assert_allclose(out[finite], ref[finite], atol=1e-4, rtol=1e-4)


def test_reparameterize_draws_from_generator():
    g = trep.CGauss(*(torch.zeros(2, 3, 4) for _ in range(5)))
    a = trep.reparameterize(g, 2, generator=torch.Generator().manual_seed(5))
    b = trep.reparameterize(g, 2, generator=torch.Generator().manual_seed(5))
    assert a.shape == (4, 3, 8)
    assert torch.equal(a, b) and a.abs().sum() > 0


@pytest.mark.parametrize("mode", ["double", "adapt"])
@pytest.mark.parametrize("which", ["speech", "noise"])
def test_split_noisy_skips_matches_jax(mode, which):
    jc, tc = configs(channel_mode=mode, skip_to_use=(0, 2, 3))
    rng = np.random.default_rng(13)
    from idccrn_vae_tpu.models.config import encoder_plan

    skips = [_rand(rng, 2, 3, 4, 2 * cout) for _, cout in encoder_plan(jc)]
    ref = jnsvae.split_noisy_skips([jnp.asarray(s) for s in skips], jc, which)
    out = tnsvae.split_noisy_skips([_t(s) for s in skips], tc, which)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
