"""The port's evaluation runners against the JAX runners on the CPU, at
tiny geometry, from the same weights (`load_jax_variables`) and the same
injected latent noise.

Each JAX runner draws its latent noise once per traced batch shape (the
patched `reparameterize` runs at trace time), so every test set here is
cut so that each batch gets a bucket of its own; the port draws at
every call, in the same sorted batch order.

Tolerances: the two sides' f32 outputs differ by ~1e-6, so scores of
enhanced outputs are held to 1e-3 absolute (PESQ-WB and ESTOI included;
none needed more) and the written wavs to one PCM16 step; scores of the
unprocessed inputs, which both sides compute from the same arrays, to
1e-9.
"""

import os
import sys

import jax
import numpy as np
import pytest

from idccrn_vae_tpu.eval import enhance as jenhance
from idccrn_vae_tpu.eval import runners as jr
from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JaxSupervised
from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_tpu.models.vae import VaeEncoder as JaxVaeEncoder
from idccrn_vae_torch.eval import enhance as tenhance
from idccrn_vae_torch.eval import runners as tr
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder
from torch_port_util import (
    NoiseStream,
    assert_json_close,
    assert_wavs_within_lsb,
    configs,
    datanorm_stats,
    np_vars,
    patch_jax_noise,
    patch_port_noise,
    read_json,
    write_test_set,
)

SCORE_ATOL = 1e-3
EXACT = 1e-9
BUCKET_FRAMES = 10  # the enhancer's buckets: 1000 samples
# batches of 2 after sorting: (9600, 12800) -> 13000 samples,
# (16000, 20000) -> 21000, (24000,) -> 25000 with 10-frame buckets
ENHANCE_LENGTHS = (16000, 9600, 24000, 12800, 20000)
# the VAE and supervised runners pad to 100-frame buckets (10000
# samples): (8500, 9500) -> 10000, (14000, 19000) -> 20000, (25000,)
RUNNER_LENGTHS = (14000, 8500, 25000, 9500, 19000)


def _bucket_kwargs(meta_path):
    from idccrn_vae_torch.cli.common import bucket_map_from_meta

    bucket_of, order = bucket_map_from_meta(meta_path)
    return {"bucket_of": bucket_of, "bucket_order": order}


def _enhancers(dual: bool, num_samples: int):
    """(JAX Enhancer, port Enhancer), the same weights."""
    extra = (dict(latent_num=2, channel_mode="double") if dual else {})
    jc, tc = configs(**extra)
    jdc, tdc = configs()
    ev = np_vars(JaxEncoder(jc).init(jax.random.PRNGKey(0)))
    dvs = [np_vars(JaxDecoder(jdc).init(jax.random.PRNGKey(k)))
           for k in (1, 2)]
    enc = load_jax_variables(NsvaeEncoder(tc, device="cpu"), ev).state_dict()
    decs = [load_jax_variables(VaeDecoder(tdc, device="cpu"),
                               v).state_dict() for v in dvs]
    kw = dict(num_samples=num_samples, bucket_frames=BUCKET_FRAMES,
              outtype="real_imag_mask" if dual else "clean_direct",
              latent_to_use=2 if dual else 1)
    noise_j, noise_t = (dvs[1], decs[1]) if dual else (None, None)
    ref = jenhance.Enhancer(jc, jdc, ev, dvs[0], noise_j, **kw)
    port = tenhance.Enhancer(tc, tdc, enc, decs[0], noise_t, device="cpu",
                             **kw)
    return ref, port


def _assert_outputs_match(got_dir, want_dir, names, files, noisy=False):
    for f in files:
        assert_json_close(read_json(got_dir, f), read_json(want_dir, f),
                          SCORE_ATOL, f)
    if noisy:
        assert_json_close(read_json(got_dir, "noisy_per_utterance.json"),
                          read_json(want_dir, "noisy_per_utterance.json"),
                          EXACT, "noisy_per_utterance.json")


@pytest.mark.parametrize("dual", [False, True], ids=["clean_direct",
                                                     "dual_real_imag_mask"])
def test_run_enhancement_eval_matches_jax(tmp_path, monkeypatch, dual):
    """per_utterance, summary (with the noisy baseline and delta),
    noisy_per_utterance, bucket_report, latent_diag (and for the dual
    latent the speech/noise silhouette) and the enhanced wavs."""
    noisy, clean, meta = write_test_set(tmp_path / "data", ENHANCE_LENGTHS)
    ref, port = _enhancers(dual, num_samples=2)
    kw = dict(batch_size=2, write_wavs=True, latent_diagnostics=True,
              **_bucket_kwargs(meta))
    patch_jax_noise(monkeypatch, NoiseStream(5))
    patch_port_noise(monkeypatch, NoiseStream(5))
    want = jr.run_enhancement_eval(ref, noisy, clean, str(tmp_path / "j"),
                                   **kw)
    got = tr.run_enhancement_eval(port, noisy, clean, str(tmp_path / "t"),
                                  **kw)
    names = [os.path.basename(p) for p in noisy]
    assert list(got["per_utterance"]) == names
    assert got.keys() == want.keys()
    assert ("silhouette_speech_vs_noise" in got["latent_diag"]) == dual
    for v in got["per_utterance"].values():
        assert np.isfinite(list(v.values())).all()
    _assert_outputs_match(str(tmp_path / "t"), str(tmp_path / "j"), names,
                          ("per_utterance.json", "summary.json",
                           "bucket_report.json"), noisy=True)
    assert_json_close(got["delta"], want["delta"], SCORE_ATOL)
    assert_wavs_within_lsb(str(tmp_path / "t" / "enhanced"),
                           str(tmp_path / "j" / "enhanced"), names)


def test_run_enhancement_eval_without_baseline_writes_the_short_summary(
        tmp_path):
    noisy, clean, _ = write_test_set(tmp_path / "data", (9900, 12000))
    _, port = _enhancers(False, num_samples=1)
    res = tr.run_enhancement_eval(port, noisy, clean, str(tmp_path / "t"),
                                  report_noisy_baseline=False)
    summary = read_json(tmp_path / "t", "summary.json")
    assert set(summary) == set(tr.METRIC_NAMES) | {"provenance"}
    assert "delta" not in res and not (tmp_path / "t" / "enhanced").exists()
    assert not (tmp_path / "t" / "noisy_per_utterance.json").exists()


def _vae_pair(dn):
    jc, tc = configs(num_samples=2)
    jenc, jdec = (JaxVaeEncoder(jc, dn and tuple(map(np.asarray, dn))),
                  JaxDecoder(jc, dn and tuple(map(np.asarray, dn))))
    ev = np_vars(jenc.init(jax.random.PRNGKey(3)))
    dv = np_vars(jdec.init(jax.random.PRNGKey(4)))
    enc = load_jax_variables(VaeEncoder(tc, dn, device="cpu"), ev)
    dec = load_jax_variables(VaeDecoder(tc, dn, device="cpu"), dv)
    return (jenc, jdec, ev, dv, jc), (enc, dec, tc)


@pytest.mark.parametrize("datanorm", [False, True])
def test_run_vae_reconstruction_eval_matches_jax(tmp_path, monkeypatch,
                                                 datanorm):
    _, clean, _ = write_test_set(tmp_path / "data", RUNNER_LENGTHS)
    dn = datanorm_stats(8) if datanorm else None
    (jenc, jdec, ev, dv, jc), (enc, dec, tc) = _vae_pair(dn)
    kw = dict(num_samples=2, batch_size=2, write_wavs=True)
    patch_jax_noise(monkeypatch, NoiseStream(9),
                    module="idccrn_vae_tpu.models.vae")
    patch_port_noise(monkeypatch, NoiseStream(9),
                     module="idccrn_vae_torch.models.vae")
    want = jr.run_vae_reconstruction_eval(jenc, jdec, ev, dv, clean,
                                          str(tmp_path / "j"), jc, **kw)
    got = tr.run_vae_reconstruction_eval(enc, dec, clean,
                                         str(tmp_path / "t"), tc, **kw)
    names = [os.path.basename(p) for p in clean]
    assert got.keys() == want.keys()
    assert_json_close({k: np.asarray(v).tolist()
                       for k, v in got["latent_diag"].items()},
                      {k: np.asarray(v).tolist()
                       for k, v in want["latent_diag"].items()}, SCORE_ATOL)
    _assert_outputs_match(str(tmp_path / "t"), str(tmp_path / "j"), names,
                          ("per_utterance.json", "summary.json"))
    assert_wavs_within_lsb(str(tmp_path / "t" / "recon"),
                           str(tmp_path / "j" / "recon"), names)
    assert (tmp_path / "t" / "cov_mu_diag.png").exists()


def test_vae_runner_without_matplotlib_writes_every_number(tmp_path,
                                                           monkeypatch):
    """The one deviation from the JAX runner: no matplotlib -> no figure
    and one log line, every number still written."""
    _, clean, _ = write_test_set(tmp_path / "data", (12000, 15000))
    _, (enc, dec, tc) = _vae_pair(None)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "t"
    res = tr.run_vae_reconstruction_eval(enc, dec, clean, str(out), tc,
                                         num_samples=2)
    assert not (out / "cov_mu_diag.png").exists()
    summary = read_json(out, "summary.json")
    assert set(summary) == {"summary", "provenance", "latent_diag"}
    assert len(summary["latent_diag"]["var_real"]) == tc.zdim
    assert len(res["per_utterance"]) == 2
    assert "matplotlib is not installed" in (out / "log.txt").read_text()


@pytest.mark.parametrize("datanorm", [False, True])
def test_run_supervised_eval_matches_jax(tmp_path, datanorm):
    noisy, clean, meta = write_test_set(tmp_path / "data", RUNNER_LENGTHS)
    dn = datanorm_stats(6) if datanorm else None
    jc, tc = configs(recon_type="mask", lstm_hidden=8)
    jmodel = JaxSupervised(jc, dn and tuple(map(np.asarray, dn)))
    variables = np_vars(jmodel.init(jax.random.PRNGKey(2)))
    model = load_jax_variables(SupervisedDccrn(tc, dn, device="cpu"),
                               variables)
    kw = dict(batch_size=2, write_wavs=True, **_bucket_kwargs(meta))
    want = jr.run_supervised_eval(jmodel, variables, noisy, clean,
                                  str(tmp_path / "j"), jc, **kw)
    got = tr.run_supervised_eval(model, noisy, clean, str(tmp_path / "t"),
                                 tc, **kw)
    names = [os.path.basename(p) for p in noisy]
    assert got.keys() == want.keys()
    assert len(got["latent_diag"]["var_real"]) == 8
    _assert_outputs_match(str(tmp_path / "t"), str(tmp_path / "j"), names,
                          ("per_utterance.json", "summary.json",
                           "bucket_report.json"))
    assert_wavs_within_lsb(str(tmp_path / "t" / "enhanced"),
                           str(tmp_path / "j" / "enhanced"), names)


def test_score_pairs_threaded_matches_serial_and_jax():
    rng = np.random.default_rng(0)
    refs = [(0.3 * np.sin(np.arange(16000) * (0.05 + 0.01 * i)))
            .astype(np.float32) for i in range(5)]
    ests = [(r + 0.05 * rng.standard_normal(len(r))).astype(np.float32)
            for r in refs]
    names = [f"u{i}.wav" for i in range(5)]
    serial = tr.score_pairs(ests, refs, names, workers=1)
    threaded = tr.score_pairs(ests, refs, names, workers=4)
    assert serial == threaded
    assert list(threaded) == names
    assert threaded == jr.score_pairs(ests, refs, names, workers=4)
    assert (tr.score_pairs(ests, refs, names, metric="sisdr")
            == jr.score_pairs(ests, refs, names, metric="sisdr"))


def test_summaries_and_names_match_jax(tmp_path):
    per = {f"u{i}": {"sisdr": float(i) * 1.5, "pesq": 1.0 + 0.1 * i}
           for i in range(7)}
    logger = tr.get_logger(str(tmp_path / "log.txt"), 1)
    assert tr.summarize_scores(per, logger) == jr.summarize_scores(per,
                                                                   logger)
    assert tr.summarize_scores({}, logger) == {}
    paths = ["/a/x/u.wav", "/b/x/u.wav", "/c/y/u.wav", "/d/v.wav",
             "/e/y/u.wav"]
    assert tr.utt_names(paths) == jr.utt_names(paths)
    assert len(set(tr.utt_names(paths))) == len(paths)
    assert tr.utt_names(paths[2:4]) == ["u.wav", "v.wav"]


def test_load_testset_resamples_like_jax(tmp_path):
    from idccrn_vae_tpu.data.audio_io import write_wav

    rng = np.random.default_rng(1)
    paths = []
    for fs, ch in ((8000, 1), (16000, 2), (22050, 1)):
        x = (0.2 * rng.standard_normal((fs // 4, ch))).astype(np.float32)
        paths.append(str(tmp_path / f"{fs}_{ch}.wav"))
        write_wav(paths[-1], x, fs)
    got, want = tr.load_testset(paths), jr.load_testset(paths)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.ndim == 1
        np.testing.assert_array_equal(g, w)
