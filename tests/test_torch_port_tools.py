"""The port's measurement tools (`idccrn_vae_torch/tools/`): each runs end
to end at the tests' CPU geometry and writes a finite report; the
programs they time compute what the JAX tools' programs compute, from
the same weights and latent draws, at f32 (torch_port_util's 1e-4);
train_bench records 'oom' for an out-of-memory error only; and every
tool refuses to run without a card unless given `--device cpu`."""

import json

import jax
import jax.numpy as jnp
import pytest
import torch

from idccrn_vae_tpu.models.config import DccrnConfig as JaxConfig
from idccrn_vae_tpu.models.config import decoder_plan as jax_decoder_plan
from idccrn_vae_tpu.models.config import freq_sizes as jax_freq_sizes
from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.nsvae import split_noisy_skips as jax_split
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from idccrn_vae_torch.tools import bench, common, profile_decoder, \
    profile_train, stream_bench, train_bench
from torch_port_util import (
    NoiseStream,
    assert_close,
    np_vars,
    patch_jax_noise,
    patch_port_noise,
    wav_batch,
)

TOOLS = {"bench": bench, "train_bench": train_bench,
         "stream_bench": stream_bench, "profile_decoder": profile_decoder,
         "profile_train": profile_train}
# short CPU runs: each tool's --tiny geometry and counts, cut further
# where a tool's default covers many points
CPU_ARGS = {"bench": ["--runs", "clean_direct:f32,dual_complex_mask:bf16",
                      "--seconds", "0.2", "--iters", "1"],
            "train_bench": ["--only", "0,8,10,11"],
            "stream_bench": ["--iters", "1"],
            "profile_decoder": [],
            "profile_train": []}


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_cpu_and_writes_finite_json(name, tmp_path):
    out = tmp_path / f"{name}.json"
    report = TOOLS[name].main(["--tiny", "--device", "cpu", "--out",
                               str(out), *CPU_ARGS[name]])
    with open(out) as f:
        written = json.load(f)
    common.finite(written)
    assert written["card"] == {"device": "cpu", "torch": torch.__version__}
    assert json.loads(json.dumps(report)) == written
    if name == "train_bench":
        assert [r["status"] for r in written["results"]] == ["ok"] * 4
        assert [r["trainer"] for r in written["results"]] == [
            "pretrain", "nsvae", "phase2_adv", "supervised"]
    if name == "profile_train":
        for prog in written["programs"].values():
            assert prog["tflop"] > 0 and 0 < prog["mfu"]
        ratio = written["decoder_conv_crosscheck"]["counted_over_analytic"]
        assert 1.0 <= ratio < 1.25


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_needs_a_card_unless_told_cpu(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TOOLS[name].main(["--tiny", "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


# ------------------------------------------------- bench's two programs


def _jax_configs(program, compute="f32"):
    enc, dec = bench.configs(program, compute, common.geometry(True))
    to_jax = lambda c: JaxConfig(**{k: getattr(c, k) for k in (
        "encoder_channels", "zdim", "causal", "num_samples", "latent_num",
        "channel_mode", "compute")})
    return (enc, dec), (to_jax(enc), to_jax(dec))


def _bridged(program, tcfgs, jcfgs):
    """JAX variables of the program's models and the port's state_dicts
    loaded from them."""
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    jvars = [np_vars(JaxEncoder(jcfgs[0]).init(keys[0])),
             np_vars(JaxDecoder(jcfgs[1]).init(keys[1]))]
    mods = [NsvaeEncoder(tcfgs[0], device="cpu"),
            VaeDecoder(tcfgs[1], device="cpu")]
    if program == "dual_complex_mask":
        jvars.append(np_vars(JaxDecoder(jcfgs[1]).init(keys[2])))
        mods.append(VaeDecoder(tcfgs[1], device="cpu"))
    states = [load_jax_variables(m, v).state_dict()
              for m, v in zip(mods, jvars)]
    return jvars, states


def test_bench_clean_direct_matches_jax_composition(monkeypatch):
    """bench.py:200-216 in JAX against `bench.clean_direct`."""
    (tc, _), (jc, _) = _jax_configs("clean_direct")
    jvars, states = _bridged("clean_direct", (tc, tc), (jc, jc))
    wav = wav_batch(1, 2, 3200)
    patch_jax_noise(monkeypatch, NoiseStream(4))
    out, _ = JaxEncoder(jc).apply(jvars[0], jnp.asarray(wav), train=False,
                                  rng=jax.random.PRNGKey(0), num_samples=1)
    skips = jax_split(out.skips, jc, "speech")
    (ref, _p), _ = JaxDecoder(jc).apply(jvars[1], out.stft_x, out.z_speech,
                                        skips, train=False, num_samples=1,
                                        pad_mode="sig")
    patch_port_noise(monkeypatch, NoiseStream(4))
    enhance = bench.clean_direct(tc, *states, torch.device("cpu"))
    assert_close(enhance(torch.from_numpy(wav)), ref)


def test_bench_dual_complex_mask_matches_jax_enhancer(monkeypatch):
    """bench.py:172-199's JAX Enhancer against `bench.dual_complex_mask`."""
    from idccrn_vae_tpu.eval.enhance import Enhancer as JaxEnhancer

    (te, td), (je, jd) = _jax_configs("dual_complex_mask")
    jvars, states = _bridged("dual_complex_mask", (te, td), (je, jd))
    wav = wav_batch(2, 2, 3200)
    patch_jax_noise(monkeypatch, NoiseStream(6))
    jenh = JaxEnhancer(je, jd, *jvars[:2], noise_dec_vars=jvars[2],
                       num_samples=1, outtype="complex_mask",
                       latent_to_use=2, pad_mode="sig")
    ref = jenh.forward(jenh.enc_vars, jenh.dec_vars, jenh.noise_dec_vars,
                       jnp.asarray(wav), jax.random.PRNGKey(0))
    patch_port_noise(monkeypatch, NoiseStream(6))
    enhance = bench.dual_complex_mask(te, td, states, torch.device("cpu"))
    assert_close(enhance(torch.from_numpy(wav)), ref)


def test_bench_measure_chains_outputs():
    """Each iteration enhances `wav + 1e-6 * previous output`."""
    calls = []

    def enhance(wav, generator):
        calls.append((wav.clone(), 2 * wav))
        return calls[-1][1]

    rec = bench.measure(enhance, 2, 0.01, 3, torch.device("cpu"))
    assert len(calls) == 5 and rec["batch"] == 2
    # RTFx = audio seconds per call / seconds per call
    assert rec["rtfx"] == pytest.approx(2 * 0.01 / (rec["ms_per_batch"]
                                                     / 1e3))
    wav = calls[0][0] / (1 + 1e-6)  # the first input chains wav itself
    for (x, _), (_, prev) in zip(calls[1:], calls[:-1]):
        # a float32 ulp of the ~0.3-amplitude input is ~3e-8
        torch.testing.assert_close(x, wav + 1e-6 * prev, rtol=0, atol=1e-7)
        assert not torch.equal(x, calls[0][0])


# ------------------------------------------------ profile_decoder


def test_profile_decoder_plan_and_macs_match_jax_tool():
    """The stage plan and MACs of tools/profile_decoder.py (:125-147)."""
    from idccrn_vae_torch.models.config import DccrnConfig

    jc = JaxConfig(causal=True, zdim=128)
    fs = [5] + list(reversed(jax_freq_sizes(jc)[:-1])) + [257]
    want = [(i, cin, cout, fs[i], fs[i + 1])
            for i, (cin, cout) in enumerate(jax_decoder_plan(jc))]
    got = profile_decoder.stage_shapes(DccrnConfig(causal=True, zdim=128))
    assert got == want
    for i, cin, cout, _f_in, f_out in got:
        dense = 32 * f_out * 481 * (2 * cin) * (2 * cout) * 5 * 2
        assert profile_decoder.macs(32, f_out, 481, cin, cout) == (
            dense, dense / 2)


@pytest.mark.parametrize("stage", range(6))
def test_profile_decoder_formulations_match_jax(stage):
    """(A), (B) and (C) of one stage against JAX's
    complex_conv_transpose2d at f32, from the same weights."""
    from idccrn_vae_tpu.ops.conv import complex_conv_transpose2d
    from idccrn_vae_torch.models.config import DccrnConfig

    cfg = DccrnConfig(causal=True, **common.geometry(True))
    _i, cin, cout, f_in, f_out = profile_decoder.stage_shapes(cfg)[stage]
    gen = torch.Generator().manual_seed(stage)
    wr, wi = profile_decoder.stage_weights(cin, cout, gen)
    x = torch.randn(2, f_in, 7, 2 * cin, generator=gen)
    hwio = lambda w: jnp.asarray(w.permute(2, 3, 0, 1).numpy())
    params = {"wr": hwio(wr), "wi": hwio(wi),
              "br": jnp.zeros(cout), "bi": jnp.zeros(cout)}
    ref = complex_conv_transpose2d(jnp.asarray(x.numpy()), params, (2, 1),
                                   (cfg.freq_pad, 0), causal=True)
    f32 = torch.float32
    assert_close(profile_decoder.current(x, wr, wi, cfg, f32), ref)
    assert_close(profile_decoder.nchw(x, wr, wi, cfg, f32), ref)
    k_sub = profile_decoder.subpixel_kernel(wr, wi, f32)
    assert_close(profile_decoder.subpixel(x, k_sub, f_out, f32), ref)
    assert profile_decoder.subpixel_error(x, wr, wi, cfg, f_out) < 1e-4


# ------------------------------------------------------- train_bench


def _failing(exc):
    def train_step(self, batch, generator, epoch):
        raise exc

    return train_step


def test_train_bench_records_oom(monkeypatch):
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    monkeypatch.setattr(PretrainTrainer, "train_step", _failing(
        torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")))
    rec = train_bench.bench("pretrain", 2, "f32", False,
                            common.geometry(True), 1600, 0.1, 1,
                            torch.device("cpu"))
    assert rec["status"] == "oom" and "injected" in rec["detail"]
    assert "step_ms" not in rec and "audio_s_per_s" not in rec


def test_train_bench_lets_other_errors_through(monkeypatch):
    from idccrn_vae_torch.train.pretrain import PretrainTrainer

    monkeypatch.setattr(PretrainTrainer, "train_step",
                        _failing(ValueError("not an OOM")))
    with pytest.raises(ValueError, match="not an OOM"):
        train_bench.bench("pretrain", 2, "f32", False, common.geometry(True),
                          1600, 0.1, 1, torch.device("cpu"))


def test_train_bench_configs_are_the_jax_tools():
    """tools/train_bench.py:139-151, in order."""
    want = [("pretrain", b, c, False) for b in (8, 16) for c in
            ("f32", "bf16")]
    want += [("pretrain", 16, "bf16", True), ("pretrain", 32, "bf16", False),
             ("pretrain", 32, "bf16", True), ("pretrain", 32, "f32", False),
             ("nsvae", 25, "bf16", False), ("phase2", 15, "bf16", False),
             ("phase2_adv", 15, "bf16", False),
             ("supervised", 48, "bf16", False),
             ("supervised", 48, "f32", False)]
    assert list(train_bench.CONFIGS) == want


def test_peaks_name_their_source():
    assert common.PEAK_TFLOPS == {"bf16": 989.4, "tf32": 494.7,
                                  "fp32": 66.9}
    assert "H100 SXM5" in common.PEAK_SOURCE
    assert common.peak_for("bf16") == (989.4, "bf16 dense")
    assert common.peak_for("int8") == (989.4, "bf16 dense")
    with pytest.raises(ValueError, match="nan"):
        common.finite({"a": [1.0, {"b": float("nan")}]})
