"""The port's int8 serving mode against the JAX package's on the CPU.

`ops/conv.quantized_conv` is the JAX package's `_quantized_conv`: the
same per-sample activation scale and per-output-channel weight scale,
round half to even, clip to +-127, exact int32 accumulation (here an
im2col through `torch._int_mm`, there an XLA int8 convolution), the
float32 dequantization rounded to bf16 and the bias added in bf16. So:
  * the int32 accumulators are equal, and so are the dequantized
    outputs: one bf16 rounding of the same float32 product on both
    sides (the tests allow that one rounding, 2**-8 relative);
  * whole models differ only where their bf16 parts do (the LSTM, the
    dense layer and the unquantized convs round at other points, and a
    quantized stage's input can then land on a neighbouring int8 step):
    held to the bf16 bound of tests/torch_port_util.py, BF16_REL = 2% of
    max |out| (read: 0.08-0.12%).

The geometry, (1, 16, 8, 16, 16, 16, 16) with the default quant_min_ch
16, quantizes encoder stages 3-5 and, with quant_scope 'all', both
halves of decoder stages 0-2, and leaves decoder stage 4 in bf16: its
concatenated input has 16 channels but each half 8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from idccrn_vae_torch.eval.enhance import Enhancer
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from idccrn_vae_torch.ops import conv as tconv
from idccrn_vae_tpu.ops import conv as jconv
from torch_port_util import (
    TINY_STFT,
    NoiseStream,
    assert_close,
    configs,
    np_vars,
    patch_jax_noise,
    wav_batch,
)

BF16_ULP = 2.0 ** -8
QUANT = dict(encoder_channels=(1, 16, 8, 16, 16, 16, 16), zdim=8,
             quant_min_ch=16, stft=TINY_STFT)
CONV_PERM = {False: (3, 2, 0, 1), True: (2, 3, 0, 1)}  # JAX HWIO -> port


def _conv_params(rng, cin, cout, scale=0.1):
    shapes = dict(wr=(5, 2, cin, cout), wi=(5, 2, cin, cout), br=(cout,),
                  bi=(cout,))
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _port_weights(p, transposed):
    perm = CONV_PERM[transposed]
    return [torch.from_numpy(np.ascontiguousarray(np.transpose(p[k], perm)))
            for k in ("wr", "wi")] + [torch.from_numpy(p[k])
                                      for k in ("br", "bi")]


def _jax_acc(x, p, transposed, causal):
    """The int32 accumulator of JAX's `_quantized_conv`, from its own
    quantization lines (idccrn_vae_tpu/ops/conv.py)."""
    kh, kw = p["wr"].shape[:2]
    wr, wi = p["wr"], p["wi"]
    if transposed:
        wr, wi = np.flip(wr, (0, 1)), np.flip(wi, (0, 1))
        pad = [(kh - 1 - 2, kh - 1 - 2),
               (kw - 1, kw - 2) if causal else (kw - 1, kw - 1)]
        stride, dil = (1, 1), (2, 1)
    else:
        pad = [(2, 2), (1, 0) if causal else (0, 0)]
        stride, dil = (2, 1), None
    kernel = jconv._block_kernel(jnp.asarray(wr), jnp.asarray(wi))
    xf = jnp.asarray(x)
    sx = jnp.maximum(jnp.max(jnp.abs(xf), axis=(1, 2, 3), keepdims=True),
                     1e-12) / 127.0
    xq = jnp.clip(jnp.round(xf / sx), -127, 127).astype(jnp.int8)
    sw = jnp.maximum(jnp.max(jnp.abs(kernel), axis=(0, 1, 2)), 1e-12) / 127.0
    kq = jnp.clip(jnp.round(kernel / sw), -127, 127).astype(jnp.int8)
    return np.asarray(lax.conv_general_dilated(
        xq, kq, stride, pad, lhs_dilation=dil,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("transposed", [False, True], ids=["conv", "tconv"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
def test_quantized_conv_matches_jax(transposed, causal):
    rng = np.random.default_rng(3)
    cin, cout = 16, 24
    x = rng.standard_normal((3, 17, 9, 2 * cin)).astype(np.float32)
    x[1] *= 7.0
    p = _conv_params(rng, cin, cout)
    pad = (2, 0) if transposed else (2, 1 if causal else 0)
    jfn = jconv.complex_conv_transpose2d if transposed else \
        jconv.complex_conv2d
    want = np.asarray(jfn(jnp.asarray(x), p, (2, 1), pad, causal=causal,
                          compute_dtype=jnp.bfloat16, quant=True,
                          quant_min_ch=16).astype(jnp.float32))
    wr, wi, br, bi = _port_weights(p, transposed)
    tfn = tconv.complex_conv_transpose2d if transposed else \
        tconv.complex_conv2d
    got = tfn(torch.from_numpy(x), wr, wi, br, bi, (2, 1), pad,
              causal=causal, compute_dtype=torch.bfloat16, quant=True,
              quant_min_ch=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_ULP,
                               atol=0)
    # the int32 accumulators, exactly
    kernel, stride, padding, dil = tconv.int8_conv_geometry(
        wr, wi, (2, 1), pad, causal, transposed)
    xq, _ = tconv.quantize_input(torch.from_numpy(x))
    kq, _ = tconv.quantize_kernel(kernel)
    acc = tconv.int8_conv_acc(xq, kq, stride, padding, dil)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(),
                                  _jax_acc(x, p, transposed, causal))


def test_int8_acc_is_exact_and_chunked(monkeypatch):
    """The im2col product equals an int64 reference at K and N that are
    not multiples of 8 and with the batch split into chunks."""
    rng = np.random.default_rng(4)
    xq = torch.from_numpy(rng.integers(-127, 128, (5, 11, 7, 6), np.int8))
    kq = torch.from_numpy(rng.integers(-127, 128, (10, 6, 5, 2), np.int8))
    monkeypatch.setattr(tconv, "IM2COL_BYTES", 1)  # one sample per chunk
    acc = tconv.int8_conv_acc(xq, kq, (2, 1), ((2, 2), (1, 0)))
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(xq.permute(0, 3, 1, 2).double(),
                                (1, 0, 2, 2)),
        kq.double(), stride=(2, 1)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(acc.numpy(), ref.numpy().astype(np.int64))


def test_activation_scale_is_per_sample():
    """A 50x louder batchmate leaves a sample's output unchanged."""
    rng = np.random.default_rng(5)
    p = _conv_params(rng, 16, 16)
    wr, wi, br, bi = _port_weights(p, False)
    x = torch.from_numpy(rng.standard_normal((2, 9, 6, 32)).astype(
        np.float32))
    loud = x.clone()
    loud[1] *= 50.0
    kw = dict(stride=(2, 1), padding=(2, 1), causal=True,
              compute_dtype=torch.bfloat16, quant=True)
    alone = tconv.complex_conv2d(x[:1], wr, wi, br, bi, **kw)
    mixed = tconv.complex_conv2d(loud, wr, wi, br, bi, **kw)
    assert torch.equal(mixed[:1], alone)
    assert not torch.equal(mixed[1:], tconv.complex_conv2d(
        x[1:], wr, wi, br, bi, **kw))


def _record_quantized(monkeypatch):
    """(JAX calls, port calls): each quantized conv as (input batch,
    kernel input channels, kernel output channels)."""
    calls = {"jax": [], "port": []}
    j_orig, t_orig = jconv._quantized_conv, tconv.quantized_conv

    def j_rec(x, kernel, *a, **kw):
        calls["jax"].append((x.shape[0], kernel.shape[2], kernel.shape[3]))
        return j_orig(x, kernel, *a, **kw)

    def t_rec(x, kernel, *a, **kw):
        calls["port"].append((x.shape[0], kernel.shape[1], kernel.shape[0]))
        return t_orig(x, kernel, *a, **kw)

    monkeypatch.setattr(jconv, "_quantized_conv", j_rec)
    monkeypatch.setattr(tconv, "quantized_conv", t_rec)
    return calls


def _enhancers(jc, tc, num_samples):
    """(JAX Enhancer, port Enhancer) from the same weights."""
    from idccrn_vae_tpu.eval.enhance import Enhancer as JEnhancer
    from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JEncoder
    from idccrn_vae_tpu.models.vae import VaeDecoder as JDecoder

    je = np_vars(JEncoder(jc).init(jax.random.PRNGKey(1)))
    jd = np_vars(JDecoder(jc).init(jax.random.PRNGKey(2)))
    te = load_jax_variables(NsvaeEncoder(tc, device="cpu"), je)
    td = load_jax_variables(VaeDecoder(tc, device="cpu"), jd)
    return (JEnhancer(jc, jc, je, jd, num_samples=num_samples),
            Enhancer(tc, tc, te.state_dict(), td.state_dict(),
                     num_samples=num_samples, device="cpu"))


def _run_both(jenh, tenh, wav, seed=7):
    s = tenh.num_samples
    b, t, h = wav.shape[0], wav.shape[1] // TINY_STFT["hop"] + 1, \
        tenh.enc_cfg.zdim
    er, ei = NoiseStream(seed)(b, s, t, h)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_noise(mp, NoiseStream(seed))
        calls = _record_quantized(mp)
        want = jenh.forward(jenh.enc_vars, jenh.dec_vars, None,
                            jnp.asarray(wav), jax.random.PRNGKey(0))
        got = tenh.forward(torch.from_numpy(wav),
                           noise=(torch.from_numpy(er), torch.from_numpy(ei)))
    return got, want, calls


@pytest.fixture(scope="module")
def int8_runs():
    """scope -> (port output, JAX output, the quantized calls of each)
    of one int8 Enhancer pair, B=2, num_samples 2."""
    runs = {}
    for scope in ("enc", "all"):
        jc, tc = configs(compute="int8", quant_scope=scope, **QUANT)
        runs[scope] = _run_both(*_enhancers(jc, tc, 2), wav_batch(4, 2, 800))
    return runs


@pytest.mark.parametrize("scope", ["enc", "all"])
def test_enhancer_int8_matches_jax(int8_runs, scope):
    got, want, calls = int8_runs[scope]
    assert_close(got, want, "bf16")
    assert calls["port"] == calls["jax"]
    enc = [(2, 32, 32)] * 3  # encoder stages 3-5 (16 -> 16 channels)
    assert calls["port"][:3] == enc
    assert len(calls["port"]) == (3 if scope == "enc" else 9), calls


def test_quant_gate_on_each_decoder_half(int8_runs):
    """Each half of a skip stage (its own x and skip weights) gates and
    scales on its own: decoder stage 4, whose halves have 8 channels
    each, stays bf16 at quant_min_ch 16 though the concatenated input
    has 16; the shared skip half runs at batch B, the x half at B * S."""
    _, _, calls = int8_runs["all"]
    dec = calls["port"][3:]
    # stages 0-2: x half at B*S = 4, then the skip half at B = 2
    assert dec == [(4, 32, 32), (2, 32, 32)] * 3, dec
    assert calls["jax"][3:] == dec


def test_supervised_int8_matches_jax():
    from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JSupervised

    jc, tc = configs(compute="int8", quant_scope="all", recon_type="mask",
                     lstm_hidden=8, **QUANT)
    variables = np_vars(JSupervised(jc).init(jax.random.PRNGKey(3)))
    port = load_jax_variables(SupervisedDccrn(tc, device="cpu"), variables)
    port.eval()
    wav = wav_batch(6, 2, 800)
    (want, _), _ = JSupervised(jc).apply(variables, jnp.asarray(wav),
                                          train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(wav))[0]
    assert_close(got, want, "bf16")


def _trainer_pairs(int8):
    """(name, JAX constructor, port constructor) of the five trainers,
    each given an int8 config."""
    from idccrn_vae_torch.train.nsvae import NsvaeTrainer
    from idccrn_vae_torch.train.phase2 import Phase2Trainer
    from idccrn_vae_torch.train.pretrain import PretrainTrainer
    from idccrn_vae_torch.train.supervised import SupervisedTrainer
    from idccrn_vae_tpu.train.nsvae import NsvaeTrainer as JNsvae
    from idccrn_vae_tpu.train.phase2 import Phase2Trainer as JPhase2
    from idccrn_vae_tpu.train.pretrain import PretrainTrainer as JPretrain
    from idccrn_vae_tpu.train.supervised import (
        SupervisedTrainer as JSupervisedTrainer,
    )

    jc, tc = int8
    cpu = dict(device="cpu")
    return [
        ("pretrain", lambda: JPretrain(jc, None, 1e-3),
         lambda: PretrainTrainer(tc, None, 1e-3, **cpu)),
        ("nsvae", lambda: JNsvae(jc, jc, None, 1e-3),
         lambda: NsvaeTrainer(tc, tc, None, 1e-3, **cpu)),
        ("phase2", lambda: JPhase2(jc, jc, None, 1e-3),
         lambda: Phase2Trainer(tc, tc, None, 1e-3, **cpu)),
        ("phase2_adversarial", lambda: JPhase2(jc, jc, None, 1e-3,
                                               adversarial=True),
         lambda: Phase2Trainer(tc, tc, None, 1e-3, adversarial=True, **cpu)),
        ("supervised", lambda: JSupervisedTrainer(jc, None, 1e-3),
         lambda: SupervisedTrainer(tc, None, 1e-3, **cpu)),
    ]


@pytest.mark.parametrize("which", ["pretrain", "nsvae", "phase2",
                                   "phase2_adversarial", "supervised"])
def test_trainers_refuse_int8_as_jax(which):
    pairs = {n: (j, t) for n, j, t in _trainer_pairs(configs(
        compute="int8"))}
    j_new, t_new = pairs[which]
    with pytest.raises(ValueError) as jerr:
        j_new()
    with pytest.raises(ValueError) as terr:
        t_new()
    assert str(terr.value) == str(jerr.value)
    assert "serving-only" in str(terr.value)
