"""The port's training ops against the JAX package on the CPU: train-mode
complex BN, the complex LSTM's backward, and every loss of the
pretraining and NSVAE stages, values and gradients.

Tolerances: values at f32 atol/rtol 1e-4 (torch_port_util.F32_TOL);
gradients at atol 5e-6 / rtol 5e-3, the gradient oracle's tolerance
(tests/test_oracle_train_step.py:130): both sides differentiate the same
f32 expressions, so their gradients differ by f32 rounding of sums taken
in another order. bf16 gradients within 2% of max |ref|: the JAX
package rounds the cotangents of bf16 operands to bf16 inside its
matmul transposes, the port keeps them in f32 (its bf16 operands are
f32 tensors holding bf16 values), so elements differ by a bf16 ulp
(2**-8 relative) per rounding.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.losses import complex_gaussian as jcg
from idccrn_vae_tpu.losses import nsvae_loss as jnl
from idccrn_vae_tpu.losses import recon as jrecon
from idccrn_vae_tpu.losses import vae_loss as jvl
from idccrn_vae_tpu.models.reparam import CGauss as JGauss
from idccrn_vae_tpu.ops import batchnorm as jbn
from idccrn_vae_torch.losses import complex_gaussian as tcg
from idccrn_vae_torch.losses import nsvae_loss as tnl
from idccrn_vae_torch.losses import recon as trecon
from idccrn_vae_torch.losses import vae_loss as tvl
from idccrn_vae_torch.models.modules import ComplexBatchNorm
from idccrn_vae_torch.models.reparam import CGauss as TGauss
from idccrn_vae_torch.ops import batchnorm as tbn
from idccrn_vae_torch.ops import lstm as tlstm
from torch_port_util import BF16_REL, GRAD_TOL, assert_close, configs
from torch_port_util import value_and_grads as _value_and_grads

jlstm = importlib.import_module("idccrn_vae_tpu.ops.lstm")

FIELDS = ("mu_r", "mu_i", "log_sigma", "delta_r", "delta_i")
BN_PARAMS = ("gamma_rr", "gamma_ri", "gamma_ii", "beta_r", "beta_i")


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(port, ref, tol, what):
    port = port.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    assert np.isfinite(port).all(), what
    np.testing.assert_allclose(port, ref, err_msg=what, **tol)


def _gauss_inputs(rng, prefix, b, t, h):
    scales = {"mu_r": 0.5, "mu_i": 0.5, "log_sigma": 0.3, "delta_r": 0.3,
              "delta_i": 0.3}
    return {f"{prefix}{k}": _rand(rng, b, t, h, scale=s)
            for k, s in scales.items()}


def _jg(d, prefix=""):
    return JGauss(**{k: d[prefix + k] for k in FIELDS})


def _tg(d, prefix=""):
    return TGauss(**{k: d[prefix + k] for k in FIELDS})


# ------------------------------------------------------------- batch norm


def _bn_inputs(rng, c):
    return {"x": _rand(rng, 2, 7, 5, 2 * c, scale=2.0) + 0.3,
            "gamma_rr": 1 + _rand(rng, c, scale=0.2),
            "gamma_ri": _rand(rng, c), "gamma_ii": 1 + _rand(rng, c, scale=0.2),
            "beta_r": _rand(rng, c, scale=0.1),
            "beta_i": _rand(rng, c, scale=0.1)}


@pytest.mark.parametrize("dis_mode", [False, True])
def test_train_batch_norm_matches_jax(dis_mode):
    """Output, gradient (input, gamma, beta) and the running update over
    two calls: the first copies the batch statistics (count 0), the
    second blends 0.9 old + 0.1 new, unless dis_mode copies again."""
    rng = np.random.default_rng(20)
    c = 3
    inputs = _bn_inputs(rng, c)
    stats0 = {k: np.asarray(v) for k, v in jbn.init_cbn_stats(c).items()}
    # a warm start: the running statistics are not the init values
    stats0.update(mean_r=_rand(rng, c), Vrr=1 + rng.random(c).astype("f"))

    def run_j(d, stats):
        params = {k: d[k] for k in BN_PARAMS}
        return jbn.complex_batch_norm(d["x"], params, stats, train=True,
                                      dis_mode=dis_mode)

    def run_t(d, stats):
        params = {k: d[k] for k in BN_PARAMS}
        return tbn.complex_batch_norm_train(d["x"], params, stats,
                                            dis_mode=dis_mode)

    jstats = jax.tree.map(jnp.asarray, stats0)
    tstats = {k: torch.tensor(np.asarray(v)).reshape(
        () if k == "count" else (1, c, 1, 1)) for k, v in stats0.items()}
    tstats["count"] = tstats["count"].long()
    _value_and_grads(lambda d: (run_j(d, jstats)[0],),
                     lambda d: (run_t(d, tstats)[0],), inputs)

    x2 = _rand(rng, 2, 7, 5, 2 * c) - 0.2
    module = ComplexBatchNorm(c, torch.Generator().manual_seed(0),
                              dis_mode=dis_mode).train()
    with torch.no_grad():
        for k in BN_PARAMS:
            getattr(module, k).copy_(torch.from_numpy(inputs[k]))
        for k, name in (("mean_r", "running_mean_real"), ("Vrr", "Vrr")):
            getattr(module, name).copy_(tstats[k])
    for x in (inputs["x"], x2):
        params = {k: jnp.asarray(inputs[k]) for k in BN_PARAMS}
        ref, jstats = jbn.complex_batch_norm(jnp.asarray(x), params, jstats,
                                             train=True, dis_mode=dis_mode)
        out = module(torch.from_numpy(x))
        assert_close(out, ref)
        assert int(module.count) == int(jstats["count"])
        for k, name in (("mean_r", "running_mean_real"),
                        ("mean_i", "running_mean_imag"), ("Vrr", "Vrr"),
                        ("Vri", "Vri"), ("Vii", "Vii")):
            assert_close(getattr(module, name).reshape(-1), jstats[k])
    assert int(module.count) == 2


def test_train_batch_norm_bf16_matches_jax():
    """bf16 activations: the statistics run in f32 on both sides, the
    output is rounded to bf16 (2% of max |ref|, see
    torch_port_util.BF16_REL)."""
    rng = np.random.default_rng(21)
    c = 4
    d = _bn_inputs(rng, c)
    stats = jbn.init_cbn_stats(c)
    params = {k: jnp.asarray(d[k]) for k in BN_PARAMS}
    ref, new = jbn.complex_batch_norm(jnp.asarray(d["x"], jnp.bfloat16),
                                      params, stats, train=True)
    tstats = {k: torch.from_numpy(np.asarray(v)) for k, v in stats.items()}
    out, tnew = tbn.complex_batch_norm_train(
        torch.from_numpy(d["x"]).bfloat16(),
        {k: torch.from_numpy(d[k]) for k in BN_PARAMS}, tstats)
    assert out.dtype == torch.bfloat16
    assert_close(out, ref, "bf16")
    for k in ("mean_r", "Vri", "Vii"):
        assert_close(tnew[k], new[k])


# ------------------------------------------------------------------- lstm


def _lstm_inputs(rng, n_in, hid, b=2, t=6):
    d = {"x": _rand(rng, b, t, 2 * n_in)}
    for part in ("re", "im"):
        for k in range(2):
            i = n_in if k == 0 else hid
            d[f"{part}{k}_w_ih"] = _rand(rng, i, 4 * hid, scale=0.3)
            d[f"{part}{k}_w_hh"] = _rand(rng, hid, 4 * hid, scale=0.3)
            d[f"{part}{k}_b_ih"] = _rand(rng, 4 * hid, scale=0.1)
            d[f"{part}{k}_b_hh"] = _rand(rng, 4 * hid, scale=0.1)
    return d


def _lstm_params(d, transpose):
    t = (lambda a: a.T) if transpose else (lambda a: a)
    return {part: [{n: t(d[f"{part}{k}_{n}"]) if n.startswith("w")
                    else d[f"{part}{k}_{n}"]
                    for n in ("w_ih", "w_hh", "b_ih", "b_hh")}
                   for k in range(2)] for part in ("re", "im")}


@pytest.mark.parametrize("compute", ["f32", "bf16"])
def test_complex_lstm_gradient_matches_jax(compute):
    """The recorded step loop's backward against jax.grad of the scan,
    with respect to the input and every weight (torch's (4H, In) weight
    layout is the transpose of the JAX one)."""
    rng = np.random.default_rng(22)
    d = _lstm_inputs(rng, 5, 3)
    cdt_j = None if compute == "f32" else jnp.bfloat16
    cdt_t = None if compute == "f32" else torch.bfloat16
    w = _rand(rng, 2, 6, 6)

    def loss_j(d):
        out = jlstm.complex_lstm(d["x"], _lstm_params(d, False),
                                 compute_dtype=cdt_j)
        return jnp.sum(out * w)

    jd = {k: jnp.asarray(v) for k, v in d.items()}
    ref, ref_grads = jax.value_and_grad(loss_j)(jd)
    td = {k: torch.tensor(v.T if "_w_" in k else v, requires_grad=True)
          for k, v in d.items()}
    out = tlstm.complex_lstm(td["x"], _lstm_params(td, False),
                             compute_dtype=cdt_t)
    (out * torch.from_numpy(w)).sum().backward()
    assert_close(out, jlstm.complex_lstm(jd["x"], _lstm_params(jd, False),
                                         compute_dtype=cdt_j), compute)
    for k, t in td.items():
        got = t.grad.T if "_w_" in k else t.grad
        if compute == "f32":
            _close(got, ref_grads[k], GRAD_TOL, k)
        else:
            want = np.asarray(ref_grads[k], np.float32)
            err = np.abs(got.numpy() - want).max()
            assert err <= BF16_REL * np.abs(want).max(), (k, err)


def test_lstm_inference_path_is_unchanged_by_recording():
    """Under no_grad the preallocated path runs; with a graph the steps
    are stacked. Both give the same values, bit for bit, at bf16 too."""
    rng = np.random.default_rng(23)
    d = _lstm_inputs(rng, 4, 3)
    params = _lstm_params({k: torch.from_numpy(v.T if "_w_" in k else v)
                           for k, v in d.items()}, False)
    x = torch.from_numpy(d["x"])
    for cdt in (None, torch.bfloat16):
        with torch.no_grad():
            fast, fast_state = tlstm.complex_lstm(x, params, cdt,
                                                  return_state=True)
        rec, rec_state = tlstm.complex_lstm(x.clone().requires_grad_(),
                                            params, cdt, return_state=True)
        assert rec.requires_grad and not fast.requires_grad
        assert torch.equal(fast, rec.detach())
        for (h0, c0), (h1, c1) in zip(fast_state, rec_state):
            assert h0.dtype == h1.dtype
            assert torch.equal(h0, h1.detach()) and torch.equal(c0,
                                                                c1.detach())


# ----------------------------------------------------------------- losses


def test_complex_kl_divergence_matches_jax():
    rng = np.random.default_rng(30)
    d = {**_gauss_inputs(rng, "a_", 2, 5, 4), **_gauss_inputs(rng, "b_", 2, 5, 4)}
    # one posterior violates |delta| < sigma: the guard's projection path
    d["a_delta_r"][0, 0] = 3.0
    _value_and_grads(
        lambda d: (jcg.complex_kl_divergence(_jg(d, "a_"), _jg(d, "b_")),),
        lambda d: (tcg.complex_kl_divergence(_tg(d, "a_"), _tg(d, "b_")),),
        d)
    # against the standard priors
    for mode in ("ri_inde", "ri_corr"):
        _value_and_grads(
            lambda d: (jcg.complex_kl_divergence(
                _jg(d, "a_"), jcg.standard_prior_like(_jg(d, "a_"), mode)),),
            lambda d: (tcg.complex_kl_divergence(
                _tg(d, "a_"), tcg.standard_prior_like(_tg(d, "a_"), mode)),),
            {k: v for k, v in d.items() if k.startswith("a_")})


def test_log_prob_and_mutual_information_match_jax():
    rng = np.random.default_rng(31)
    b, s, t, h = 3, 2, 4, 4
    d = {**_gauss_inputs(rng, "", b, t, h), "zr": _rand(rng, b, s, t, h),
         "zi": _rand(rng, b, s, t, h)}
    _value_and_grads(
        lambda d: (jcg.complex_gaussian_log_prob(_jg(d), d["zr"], d["zi"]),
                   jcg.mutual_information(_jg(d), d["zr"], d["zi"])),
        lambda d: (tcg.complex_gaussian_log_prob(_tg(d), d["zr"], d["zi"]),
                   tcg.mutual_information(_tg(d), d["zr"], d["zi"])),
        d)


@pytest.mark.parametrize("ref_mag_bug", [False, True])
def test_recon_losses_match_jax(ref_mag_bug):
    rng = np.random.default_rng(32)
    d = {"pred": _rand(rng, 3, 9, 5, 2), "tgt": _rand(rng, 3, 9, 5, 2),
         "src": _rand(rng, 3, 40), "est": _rand(rng, 3, 40)}
    w = (1.0, 0.5, 0.2)
    _value_and_grads(
        lambda d: jrecon.multiple_recon_loss(d["pred"], d["tgt"], d["src"],
                                             d["est"], w, ref_mag_bug)
        + (jrecon.prob_recon_loss(d["pred"], d["tgt"]),),
        lambda d: trecon.multiple_recon_loss(d["pred"], d["tgt"], d["src"],
                                             d["est"], w, ref_mag_bug)
        + (trecon.prob_recon_loss(d["pred"], d["tgt"]),),
        d)


@pytest.mark.parametrize("recon", ["multiple", "prob"])
def test_pretrain_vae_loss_matches_jax(recon):
    """Every VaeLossOut field, mi_weight != 0, and the gradients with
    respect to the decoder outputs, the posterior and the samples."""
    rng = np.random.default_rng(33)
    b, s, t, h, f, n = 2, 3, 5, 4, 9, 40
    kw = dict(kl_weight=0.02, mi_weight=0.3, recon_loss_type=recon,
              recon_loss_weight=(1.0, 0.7, 0.1), num_samples=s,
              prior_mode="ri_corr")
    warm = jvl.kl_annealing_schedule(4)
    jl, tl = jvl.PretrainVaeLoss(warm, **kw), tvl.PretrainVaeLoss(warm, **kw)
    d = {**_gauss_inputs(rng, "", b, t, h),
         "src": _rand(rng, b * s, n), "est": _rand(rng, b * s, n),
         "tgt": _rand(rng, b * s, f, t, 2), "pred": _rand(rng, b * s, f, t, 2),
         "z": _rand(rng, b * s, t, 2 * h)}
    for epoch in (1, 7):
        assert tl.kl_weight_at(epoch) == jl.kl_weight_at(epoch)
    kl_w = tl.kl_weight_at(1)
    _value_and_grads(
        lambda d: tuple(jl(d["src"], d["est"], d["tgt"], d["pred"], _jg(d),
                           d["z"], jnp.float32(kl_w))),
        lambda d: tuple(tl(d["src"], d["est"], d["tgt"], d["pred"], _tg(d),
                           d["z"], kl_w)),
        d)


@pytest.mark.parametrize("latent_num,channel_mode", [(1, "normal"),
                                                     (2, "double")])
def test_nsvae_true_kl_loss_matches_jax(latent_num, channel_mode):
    """Every NsvaeLossOut field (matching='both', w_resi != 0: the
    residual matching through split_noisy_skips) and the gradients with
    respect to every posterior and skip."""
    rng = np.random.default_rng(34 + latent_num)
    jc, tc = configs(latent_num=latent_num, channel_mode=channel_mode,
                     skip_to_use=(0, 2, 5))
    kw = dict(alpha=0.7, w_resi=0.5, w_kl=1.3, w_dismiu=0.4,
              matching="both")
    jl = jnl.NsvaeTrueKlLoss(cfg=jc, **kw)
    tl = tnl.NsvaeTrueKlLoss(cfg=tc, **kw)
    b, t, h = 2, 5, 4
    d = {}
    for g in ("c_", "n_", "s_", "m_"):
        d.update(_gauss_inputs(rng, g, b, t, h))
    mult = 2 if channel_mode == "double" else 1
    for i, ch in enumerate(tc.encoder_channels[1:]):
        for who, width in (("sc", ch), ("sn", ch), ("sy", mult * ch)):
            d[f"{who}{i}"] = _rand(rng, b, 6 - i // 2, t, 2 * width)
    n = tc.num_stages
    skips = lambda d, who: [d[f"{who}{i}"] for i in range(n)]

    def run(loss, gauss, d):
        return tuple(loss(gauss(d, "c_"), gauss(d, "n_"), gauss(d, "s_"),
                          gauss(d, "m_") if latent_num == 2 else None,
                          skips(d, "sc"), skips(d, "sn"), skips(d, "sy")))

    grads = _value_and_grads(lambda d: run(jl, _jg, d),
                             lambda d: run(tl, _tg, d), d)
    assert grads["s_mu_r"].abs().max() > 0


@pytest.mark.parametrize("args", [(20,), (10, 0.0, 1.0, 2, 0.5), (7, 0.1, 0.9),
                                  (1,), (5, 0.0, 1.0, 3, 1.0)])
def test_kl_annealing_schedule_is_exact(args):
    want = jvl.kl_annealing_schedule(*args)
    got = tvl.kl_annealing_schedule(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_train_step_after_inference_mode_serving():
    """The STFT window and OLA envelope are cached per device and dtype:
    a serving call under inference_mode that caches them first must not
    make a later training step fail to save them for backward."""
    from idccrn_vae_torch.ops import stft as tstft

    tstft._padded_hann.cache_clear()
    tstft._ola_envelope.cache_clear()
    x = torch.randn(2, 333)
    with torch.inference_mode():
        tstft.istft(tstft.stft(x, 32, 8, 16), 32, 8, 16)
    y = x.clone().requires_grad_()
    out = tstft.istft(tstft.stft(y, 32, 8, 16), 32, 8, 16)
    out.square().sum().backward()
    assert y.grad is not None and torch.isfinite(y.grad).all()
