"""The supervised DCCRN's trainer and the corpus statistics
(`corpus_mean_std`, the cal_mean_std CLI's function) in the port, against
the JAX package on the CPU.

Tolerances: one SGD step as in tests/test_torch_port_trainers.py (the
losses at F32_TOL, each parameter's delta at atol 5e-6 / rtol 5e-3, the
new BN statistics at F32_TOL, the counters exactly); the corpus mean and
std to 1e-6 relative (both sides take one f32 rfft per frame and add the
flushes up in float64).
"""

import os

import jax
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.data import stats as jstats
from idccrn_vae_tpu.data.audio_io import write_wav
from idccrn_vae_torch.data import stats as tstats
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.modules import bn_counts
from torch_port_util import (
    check_metrics,
    check_models,
    np_vars,
    supervised_pair,
    train_wav,
)

STATS_REL = 1e-6


@pytest.mark.parametrize("datanorm", [False, True],
                         ids=["plain", "datanorm"])
def test_supervised_sgd_step_matches_jax(datanorm):
    """One SGD step of the supervised_dccrn.ini usage line (causal, mask,
    real skips) at tiny geometry: the losses against the raw target
    spectrogram (with datanorm, the de-normalised prediction), every
    parameter's delta, the BN statistics and counters, then the
    validation metrics of the stepped model."""
    jtr, state, ttr = supervised_pair(datanorm)
    before = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    batch = (train_wav(1), train_wav(2))
    s1, want = jtr.train_step(state, batch, jax.random.PRNGKey(0), 0)
    got = ttr.train_step(batch, None, 0)
    check_metrics(got, want)
    assert check_models(ttr.model, before, s1["model"], "model",
                        prefix="std_DCCRN") > 1e-4
    assert bn_counts(ttr.model).tolist() == [1] * 12
    # eval-mode BN of the stepped weights; with datanorm its outputs are
    # ill-conditioned (test_torch_port_trainers.py), so the stepped JAX
    # weights are loaded to hold eval_step itself at F32_TOL
    load_jax_variables(ttr.model, np_vars(s1["model"]))
    check_metrics(ttr.eval_step(batch, None, 0),
                  jtr.eval_step(s1, batch, jax.random.PRNGKey(1), 0))
    meta = ttr.meta_fields()
    assert sorted(meta) == ["config", "datanorm"]
    assert (meta["datanorm"] is None) == (not datanorm)


# ------------------------------------------------------------ corpus stats


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    """Five 16 kHz files of 0.2-1.4 s (one too short to frame after
    trimming its leading and trailing silence), written as PCM16."""
    root = tmp_path_factory.mktemp("stats")
    rng = np.random.default_rng(9)
    paths = []
    for i, n in enumerate((22400, 16000, 3200, 9600, 300)):
        x = 0.2 * rng.standard_normal(n) * np.hanning(n)
        x[: n // 8] = 0.0  # silence for trim_silence to cut
        paths.append(str(root / f"u{i}.wav"))
        write_wav(paths[-1], x.astype(np.float32), 16000)
    return paths


@pytest.mark.parametrize("trim,nfft,hop,win", [
    (True, 512, 100, 400), (False, 512, 100, 400), (False, 64, 16, 48)],
    ids=["trim", "no_trim", "small_fft"])
def test_corpus_mean_std_matches_jax(monkeypatch, wav_files, trim, nfft,
                                     hop, win):
    """Mean and std per (bin, re/im) against the JAX function, with a
    flush buffer of 64 frames so that the frames cross many full flushes
    and end in a partial one."""
    monkeypatch.setattr(jstats, "_CHUNK", 64)
    monkeypatch.setattr(tstats, "_CHUNK", 64)
    kw = dict(n_fft=nfft, hop=hop, win_length=win, trim=trim)
    want = jstats.corpus_mean_std(wav_files, **kw)
    got = tstats.corpus_mean_std(wav_files, device="cpu", **kw)
    for g, w, name in zip(got, want, ("mean", "std")):
        assert g.shape == w.shape == (nfft // 2 + 1, 2) and g.dtype == w.dtype
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= STATS_REL * scale, name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=STATS_REL * scale,
                                   err_msg=name)


def test_corpus_mean_std_refuses_an_empty_corpus(wav_files, tmp_path):
    with pytest.raises(ValueError, match="0 frames"):
        tstats.corpus_mean_std(wav_files[-1:], trim=False, device="cpu")
    other = str(tmp_path / "8k.wav")
    write_wav(other, np.zeros(4000, np.float32), 8000)
    with pytest.raises(ValueError, match="unexpected fs"):
        tstats.corpus_mean_std([other], device="cpu")


def test_corpus_mean_std_defaults_to_the_card(wav_files):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstats.corpus_mean_std(wav_files)


def test_stats_txt_round_trip_matches_jax(tmp_path, wav_files):
    """save_stats_txt writes the JAX package's bytes; load_stats_txt reads
    them back as (F, 2) float32."""
    mean, std = tstats.corpus_mean_std(wav_files[:2], device="cpu")
    for name, arr in (("mean", mean), ("std", std)):
        t, j = str(tmp_path / f"t_{name}.txt"), str(tmp_path / f"j_{name}.txt")
        tstats.save_stats_txt(t, arr)
        jstats.save_stats_txt(j, arr)
        with open(t, "rb") as ft, open(j, "rb") as fj:
            assert ft.read() == fj.read()
    got = tstats.load_stats_txt(str(tmp_path / "t_mean.txt"),
                                str(tmp_path / "t_std.txt"))
    for g, w in zip(got, (mean, std)):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert os.path.getsize(str(tmp_path / "t_mean.txt")) > 0
