"""The port's host-side evaluation modules against the JAX package's:
wav I/O, resampling, silence trim, file discovery, the native metrics
(RMSE, SI-SDR, STOI/ESTOI, PESQ-WB), the CI helpers, the bucket report,
the latent diagnostics, the synthetic corpus and the checkpoint
datanorm entries.

The port keeps its own copies of these numpy/scipy modules, so the
arithmetic is the same: scores are held to 1e-9 absolute and written
files byte for byte.
"""

import json
import os
import wave

import numpy as np
import pytest

from idccrn_vae_torch.data import audio_io as t_io
from idccrn_vae_torch.data import segments as t_seg
from idccrn_vae_torch.data import synth as t_synth
from idccrn_vae_torch.eval import diagnostics as t_diag
from idccrn_vae_torch.eval import metrics as t_met
from idccrn_vae_torch.eval import pesq_native as t_pesq
from idccrn_vae_torch.eval import report as t_rep
from idccrn_vae_torch.train import checkpoint as t_ckpt
from idccrn_vae_tpu.data import audio_io as j_io
from idccrn_vae_tpu.data import segments as j_seg
from idccrn_vae_tpu.data import synth as j_synth
from idccrn_vae_tpu.eval import diagnostics as j_diag
from idccrn_vae_tpu.eval import metrics as j_met
from idccrn_vae_tpu.eval import pesq_native as j_pesq
from idccrn_vae_tpu.eval import report as j_rep
from idccrn_vae_tpu.train import checkpoint as j_ckpt
import torch_port_util  # noqa: F401  (caps torch's threads)

ATOL = 1e-9
FS = 16000


def _pair(seed: int, snr_db: float, seconds: float = 1.2, fs: int = FS):
    """(clean speech-like, noisy at snr_db), float32, from a seed."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    clean = j_synth.synth_speech(rng, n, fs)
    noise, _ = j_synth.synth_noise(rng, n, fs)
    noisy, _ = j_synth.mix_at_snr(clean, noise, snr_db)
    return clean, noisy


# ------------------------------------------------------------------ wav I/O


def test_write_wav_is_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    x = np.clip(0.5 * rng.standard_normal(3001), -1.2, 1.2).astype(np.float32)
    stereo = (0.3 * rng.standard_normal((800, 2))).astype(np.float32)
    for name, sig in (("mono", x), ("stereo", stereo)):
        j_io.write_wav(str(tmp_path / f"j_{name}.wav"), sig, FS)
        t_io.write_wav(str(tmp_path / f"t_{name}.wav"), sig, FS)
        assert ((tmp_path / f"j_{name}.wav").read_bytes()
                == (tmp_path / f"t_{name}.wav").read_bytes())


@pytest.mark.parametrize("width", [1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 2])
def test_read_wav_matches_jax(tmp_path, width, channels):
    """PCM8/16/24/32 written with the wave module read back alike."""
    rng = np.random.default_rng(width * 10 + channels)
    raw = rng.integers(0, 256, size=401 * width * channels,
                       dtype=np.uint8).tobytes()
    path = str(tmp_path / "in.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(22050)
        w.writeframes(raw)
    (tx, tfs), (jx, jfs) = t_io.read_wav(path), j_io.read_wav(path)
    assert tfs == jfs == 22050
    assert tx.dtype == jx.dtype == np.float32 and tx.shape == jx.shape
    np.testing.assert_array_equal(tx, jx)


def test_wav_round_trip_is_one_lsb(tmp_path):
    x = (0.4 * np.sin(np.linspace(0, 300, 5000))).astype(np.float32)
    path = str(tmp_path / "r.wav")
    t_io.write_wav(path, x, FS)
    y, fs = t_io.read_wav(path)
    assert fs == FS and y.shape == x.shape
    assert np.abs(y - x).max() <= 1.0 / 32768


@pytest.mark.parametrize("fs_in,fs_out", [(8000, 16000), (44100, 16000),
                                          (16000, 10000), (16000, 16000)])
def test_resample_matches_jax(fs_in, fs_out):
    x = np.random.default_rng(fs_in).standard_normal(fs_in // 3)
    x = x.astype(np.float32)
    t, j = t_io.resample(x, fs_in, fs_out), j_io.resample(x, fs_in, fs_out)
    assert t.dtype == j.dtype and t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_trim_silence_matches_jax():
    clean, _ = _pair(3, 10.0, seconds=2.0)
    padded = np.concatenate([np.zeros(4000, np.float32), clean,
                             np.zeros(3000, np.float32)])
    for x in (padded, np.zeros(10, np.float32), np.zeros(0, np.float32)):
        for top_db in (20.0, 30.0, 60.0):
            assert (t_io.trim_silence(x, top_db)
                    == j_io.trim_silence(x, top_db))


def test_find_wavs_and_companions_match_jax(tmp_path):
    for rel in ("b/noisy_fileid_2.wav", "a/noisy_fileid_10.wav",
                "a/x.flac", "c/noisy_fileid_1.wav", "notes.txt"):
        p = tmp_path / rel
        p.parent.mkdir(exist_ok=True)
        p.write_bytes(b"")
    lst = tmp_path / "list.txt"
    lst.write_text("/x/one.wav\n/x/two.flac\n/x/three.wav\n")
    for path, suffix in ((str(tmp_path), "wav"), (str(tmp_path), "flac"),
                         (str(lst), "wav")):
        assert (t_seg.find_wavs(path, suffix)
                == j_seg.find_wavs(path, suffix))
    for p in t_seg.find_wavs(str(tmp_path)):
        assert (t_seg.companion_paths(p, "/c", "/n")
                == j_seg.companion_paths(p, "/c", "/n"))
    with pytest.raises(ValueError, match="fileid"):
        t_seg.companion_paths("/d/plain.wav", "/c", "/n")


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("snr_db", [-5.0, 5.0, 20.0])
@pytest.mark.parametrize("fs", [16000, 8000])
def test_eval_metrics_all_match_jax(snr_db, fs):
    """EvalMetrics('all') = (rmse, sisdr, pesq_wb, estoi); at 8 kHz the
    PESQ and STOI inputs are resampled inside the metric."""
    clean, noisy = _pair(31 + int(snr_db), snr_db, seconds=2.0, fs=fs)
    t = t_met.EvalMetrics("all").eval(noisy, clean, fs)
    j = j_met.EvalMetrics("all").eval(noisy, clean, fs)
    assert len(t) == len(j) == 4
    np.testing.assert_allclose(np.array(t, np.float64),
                               np.array(j, np.float64), rtol=0, atol=ATOL)
    assert np.isfinite(t).all()


@pytest.mark.parametrize("metric", ["rmse", "sisdr", "pesq", "stoi",
                                    "estoi"])
def test_each_metric_matches_jax(metric):
    clean, noisy = _pair(7, 3.0)
    est = noisy[: len(noisy) - 37]  # lengths differ: both trim
    t = t_met.EvalMetrics(metric).eval(est, clean, FS, "x")
    j = j_met.EvalMetrics(metric).eval(est, clean, FS, "x")
    assert abs(float(t) - float(j)) <= ATOL


@pytest.mark.parametrize("extended", [False, True])
def test_stoi_matches_jax(extended):
    clean, noisy = _pair(11, 0.0, seconds=1.5)
    for fs in (FS, 10000):
        t = t_met.stoi(clean, noisy, fs, extended=extended)
        j = j_met.stoi(clean, noisy, fs, extended=extended)
        assert abs(t - j) <= ATOL
    # shorter than one segment: both return the same floor value
    with pytest.warns(UserWarning):
        short = t_met.stoi(clean[:2000], noisy[:2000], FS, extended)
    with pytest.warns(UserWarning):
        assert short == j_met.stoi(clean[:2000], noisy[:2000], FS, extended)


@pytest.mark.parametrize("snr_db", [0.0, 10.0, 30.0])
def test_pesq_wb_native_matches_jax(snr_db):
    clean, noisy = _pair(20 + int(snr_db), snr_db)
    delayed = np.concatenate([np.zeros(160, np.float32), noisy])[: len(noisy)]
    for deg in (noisy, delayed, clean):
        t = t_pesq.pesq_wb_native(clean, deg, FS)
        j = j_pesq.pesq_wb_native(clean, deg, FS)
        assert abs(t - j) <= ATOL
    assert (t_met.pesq_wb(8000, clean[::2], noisy[::2])
            == pytest.approx(j_met.pesq_wb(8000, clean[::2], noisy[::2]),
                             abs=ATOL))


def test_pesq_refusal_is_zero_in_both():
    silent = np.zeros(16000, np.float32)
    deg = np.random.default_rng(0).standard_normal(16000).astype(np.float32)
    with pytest.warns(UserWarning, match="substituting 0.0"):
        assert t_met.pesq_wb(FS, silent, deg) == 0.0
    with pytest.warns(UserWarning, match="substituting 0.0"):
        assert j_met.pesq_wb(FS, silent, deg) == 0.0


def test_ci_helpers_and_provenance_match_jax():
    data = np.random.default_rng(4).standard_normal(37) * 3 + 1
    for fn in ("compute_mean", "compute_median"):
        t, j = getattr(t_met, fn)(data), getattr(j_met, fn)(data)
        np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
        with pytest.raises(NameError, match="nan"):
            getattr(t_met, fn)(np.array([1.0, np.nan]))
    assert t_met.metric_provenance() == j_met.metric_provenance()
    assert t_met.EvalMetrics().provenance == {"pesq_impl": "native",
                                              "stoi_impl": "native"}
    with pytest.raises(ValueError, match="only supports"):
        t_met.EvalMetrics("snr").eval(data, data, FS)


# ---------------------------------------------------- report / diagnostics


def _scores(seed: int, names):
    rng = np.random.default_rng(seed)
    return {n: {m: float(rng.normal(loc, 1.0))
                for m, loc in (("sisdr", 5), ("pesq", 2), ("estoi", 0.5),
                               ("rmse", 0.1))} for n in names}


def test_bucket_report_matches_jax():
    names = [f"noisy_fileid_{i}.wav" for i in range(11)]
    enh, noisy = _scores(1, names), _scores(2, names[:-2])
    labels = ["[0,5)", "[5,10)", "[10,15)"]
    bucket_of = {n: labels[i % 3] for i, n in enumerate(names[:-1])}
    for order in (labels, None, ["[10,15)", "[0,5)"]):
        t = t_rep.bucketed_median_report(enh, noisy, bucket_of, order)
        j = j_rep.bucketed_median_report(enh, noisy, bucket_of, order)
        assert json.dumps(t) == json.dumps(j)
        assert t_rep.format_bucket_table(t) == j_rep.format_bucket_table(j)
    assert "(unbucketed)" in t


def test_plot_bucket_boxes_writes_the_figure(tmp_path):
    pytest.importorskip("matplotlib")
    names = [f"u{i}.wav" for i in range(8)]
    bucket_of = {n: ["[0,5)", "[5,10)"][i % 2] for i, n in enumerate(names)}
    out = tmp_path / "boxes.png"
    t_rep.plot_bucket_boxes({"noisy": _scores(3, names),
                             "enhanced": _scores(4, names)}, bucket_of,
                            str(out), baseline="noisy")
    assert out.stat().st_size > 0


def test_latent_diagnostics_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    mus = [rng.standard_normal((t, 6, 2)) for t in (13, 7, 21)]
    noise = [rng.standard_normal((t, 6, 2)) + 0.5 for t in (13, 7, 21)]
    t, j = t_diag.mu_covariance(mus), j_diag.mu_covariance(mus)
    assert t.keys() == j.keys()
    for k in t:
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=ATOL)
    for is_logsigma in (False, True):
        assert abs(t_diag.posterior_distance(mus[0], noise[0], is_logsigma)
                   - j_diag.posterior_distance(mus[0], noise[0],
                                               is_logsigma)) <= ATOL
    assert (t_diag.latent_silhouette(mus, noise, max_points=40)
            == j_diag.latent_silhouette(mus, noise, max_points=40))
    pytest.importorskip("matplotlib")
    t_diag.plot_cov_diagonals(t, str(tmp_path / "cov.png"))
    assert (tmp_path / "cov.png").stat().st_size > 0


# ------------------------------------------------------------------ corpus


def _tree_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("buckets", [t_synth.SNR_BUCKETS, ((-5.0, 0.0),)])
def test_make_corpus_matches_jax(tmp_path, buckets):
    kw = dict(n_train=1, n_val=5, utt_seconds=0.75, buckets=buckets,
              seed=17)
    t_dirs, t_meta = t_synth.make_corpus(str(tmp_path / "t"), **kw)
    j_dirs, j_meta = j_synth.make_corpus(str(tmp_path / "j"), **kw)
    assert t_meta == j_meta
    assert t_dirs.keys() == j_dirs.keys()
    t_files, j_files = _tree_bytes(tmp_path / "t"), _tree_bytes(tmp_path / "j")
    assert len(t_files) == 3 * 6 + 1
    assert t_files == j_files


def test_make_synth_corpus_cli_matches_jax(tmp_path, capsys):
    from idccrn_vae_torch.cli.make_synth_corpus import main as t_main
    from idccrn_vae_tpu.cli.make_synth_corpus import main as j_main

    args = ["--n_train", "0", "--n_val", "2", "--utt_seconds", "0.5",
            "--seed", "3", "--snr_lo", "2", "--snr_hi", "4"]
    t_main(["--out", str(tmp_path / "t"), *args])
    j_main(["--out", str(tmp_path / "j"), *args])
    assert _tree_bytes(tmp_path / "t") == _tree_bytes(tmp_path / "j")
    assert "wrote 2 noisy utterances" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="together"):
        t_main(["--out", str(tmp_path / "x"), "--snr_lo", "1"])


def test_datanorm_meta_matches_jax():
    rng = np.random.default_rng(2)
    dn = (rng.standard_normal((257, 2)).astype(np.float32),
          (1 + rng.random((257, 2))).astype(np.float32))
    meta = t_ckpt.datanorm_to_meta(dn)
    assert json.dumps(meta) == json.dumps(j_ckpt.datanorm_to_meta(dn))
    assert t_ckpt.datanorm_to_meta(None) is None
    back = t_ckpt.datanorm_from_meta({"datanorm": meta})
    for got, want in zip(back, j_ckpt.datanorm_from_meta({"datanorm": meta})):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(back[0], dn[0])
    assert t_ckpt.datanorm_from_meta({}) is None
