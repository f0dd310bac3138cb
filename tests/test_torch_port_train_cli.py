"""The port's training CLIs end to end on the CPU: `train_vae` on clean
speech (CVAE) and on noise (NVAE), `train_nsvae` against both, then the
port's `test_enhance --phase 1` on their run dirs, all with
`--device cpu` on a tiny synthetic corpus and an ini the test writes.
The JAX CLIs run once on the same ini and flags: the port's meta.json
has their keys and configs. `--reload` resumes at the next epoch and
refuses to run without `--reload_savedir`.

Trajectories are held against the JAX trainers in
tests/test_torch_port_trainers.py; here the CLI surface is checked:
every loss and score finite, the epoch counters, the files of a run dir.
"""

import json
import math
import os
import shutil

import numpy as np
import pytest

from torch_port_util import finite_curves as _finite_curves
from torch_port_util import run_dir as _run_dir
from torch_port_util import train_ini as _ini

FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--num_samples", "2",
         "--causal", "--skip_padding", "--kl_weight", "0.01",
         "--recon_loss_weight", "1.0,1.0,0.0"]
NSVAE_FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--causal",
               "--latent_num", "2", "--nsvae_model", "original",
               "--alpha", "1.0", "--w_kl", "1.0", "--w_dismiu", "0.1"]
RUN_FILES = ["best.pt", "loss_curves.json", "meta.json", "state.pt",
             "train.log"]


def _train_vae(side, root, dirs, kind):
    """train_vae on `kind` ('clean' or 'noise') of the corpus; returns
    (the CLI's return value, the run dir)."""
    if side == "port":
        from idccrn_vae_torch.cli.train_vae import main
        extra = ["--device", "cpu"]
    else:
        from idccrn_vae_tpu.cli.train_vae import main
        extra = []
    saved = os.path.join(root, f"{side}_{kind}_runs")
    ini = _ini(os.path.join(root, f"{side}_{kind}.ini"), saved,
               f"{kind}_vae", {"train_data_dir": dirs[f"{kind}_train"],
                               "val_data_dir": dirs[f"{kind}_val"]})
    out = main(["--cfg_file", ini, "--first_use_dataset", *FLAGS, *extra])
    return out, _run_dir(saved)


def _nsvae_ini(root, side, dirs, clean_run, noise_run, epochs=2):
    user = {f"{k}_{s}_data_dir": dirs[f"{k}_{s}"]
            for k in ("noisy", "clean", "noise") for s in ("train", "val")}
    user.update(pre_clean_encoder=clean_run, pre_noise_encoder=noise_run)
    return _ini(os.path.join(root, f"{side}_nsvae_{epochs}.ini"),
                os.path.join(root, f"{side}_nsvae_runs"), "nsvae", user,
                epochs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's CVAE, NVAE and NSVAE runs and the JAX CLIs' CVAE and
    NSVAE runs (the JAX NSVAE matches against the JAX CVAE twice: only
    its meta.json is compared)."""
    from idccrn_vae_torch.cli.train_nsvae import main as t_nsvae
    from idccrn_vae_torch.data.synth import make_corpus
    from idccrn_vae_tpu.cli.train_nsvae import main as j_nsvae

    root = str(tmp_path_factory.mktemp("train_cli"))
    dirs, _ = make_corpus(os.path.join(root, "corpus"), 4, 2,
                          utt_seconds=0.5, seed=11)
    out = {"root": root, "dirs": dirs}
    for kind in ("clean", "noise"):
        out[f"port_{kind}"] = _train_vae("port", root, dirs, kind)
    out["jax_clean"] = _train_vae("jax", root, dirs, "clean")
    ini = _nsvae_ini(root, "port", dirs, out["port_clean"][1],
                     out["port_noise"][1])
    res = t_nsvae(["--cfg_file", ini, "--first_use_dataset", *NSVAE_FLAGS,
                   "--device", "cpu"])
    out["port_nsvae"] = res, res[2]
    jrun = out["jax_clean"][1]
    j_nsvae(["--cfg_file", _nsvae_ini(root, "jax", dirs, jrun, jrun),
             "--first_use_dataset", *NSVAE_FLAGS])
    out["jax_nsvae"] = (None, _run_dir(os.path.join(root, "jax_nsvae_runs")))
    return out


def _meta(run_dir):
    with open(os.path.join(run_dir, "meta.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("stage", ["clean", "noise", "nsvae"])
def test_train_cli_runs_and_writes_a_run_dir(runs, stage):
    """Two epochs, finite losses, the run dir's files, the epoch counter
    and loss_curves.json as returned."""
    (curves, best, run_dir), saved = runs[f"port_{stage}"]
    assert run_dir == saved
    _finite_curves(curves, 2)
    assert math.isfinite(best)
    assert sorted(os.listdir(run_dir)) == RUN_FILES
    meta = _meta(run_dir)
    assert meta["epoch"] == 1 and meta["best_val"] == best
    with open(os.path.join(run_dir, "loss_curves.json")) as f:
        assert json.load(f) == curves
    from idccrn_vae_torch.train.checkpoint import CheckpointManager

    best_pt = CheckpointManager(run_dir).load_best()
    want = ({"clean_enc", "noise_enc", "noisy_enc"} if stage == "nsvae"
            else {"enc", "dec"})
    assert set(best_pt) == want


@pytest.mark.parametrize("stage", ["clean", "nsvae"])
def test_meta_has_the_jax_cli_keys(runs, stage):
    """The same flags and ini give the JAX CLI's meta.json keys, configs,
    scheduler state keys and epoch counter (the values of best_val,
    patience and the schedulers follow each side's own random init)."""
    got = _meta(runs[f"port_{stage}"][1])
    want = _meta(runs[f"jax_{stage}"][1])
    assert sorted(got) == sorted(want)
    for key in ("config", "pre_config", "noisy_config"):
        if key in want:
            assert got[key] == want[key], key
    for key, value in want.items():
        if key.startswith("sched"):
            assert sorted(got[key]) == sorted(value), key
        elif key in ("epoch", "model_name", "trainable", "datanorm"):
            assert got[key] == value, key


def test_test_enhance_reads_the_trained_dirs(runs, tmp_path):
    """Phase 1 enhancement from the NSVAE run (noisy encoder) and the
    CVAE run (decoder): every score finite."""
    from idccrn_vae_torch.cli.test_enhance import main

    dirs = runs["dirs"]
    res = main(["--nsvae_dir", runs["port_nsvae"][1], "--decoder_dir",
                runs["port_clean"][1], "--noisy_dir", dirs["noisy_val"],
                "--clean_dir", dirs["clean_val"], "--out_dir",
                str(tmp_path / "eval"), "--num_samples", "2", "--compute",
                "f32", "--device", "cpu"])
    per = res["per_utterance"]
    assert len(per) == 2
    assert all(np.isfinite(list(v.values())).all() for v in per.values())


def test_reload_resumes_at_the_next_epoch(runs, tmp_path):
    """--reload --reload_savedir with one more epoch in the ini runs
    epoch 2 only, from the saved state; --reload alone exits."""
    from idccrn_vae_torch.cli.train_nsvae import main as t_nsvae
    from idccrn_vae_torch.cli.train_vae import main as t_vae

    dirs = runs["dirs"]
    run = str(tmp_path / "resumed")
    shutil.copytree(runs["port_nsvae"][1], run)
    ini = _nsvae_ini(str(tmp_path), "port", dirs, runs["port_clean"][1],
                     runs["port_noise"][1], epochs=3)
    curves, best, run_dir = t_nsvae(
        ["--cfg_file", ini, *NSVAE_FLAGS, "--device", "cpu", "--reload",
         "--reload_savedir", run])
    assert run_dir == run
    _finite_curves(curves, 1)
    meta = _meta(run)
    assert meta["epoch"] == 2
    assert best <= _meta(runs["port_nsvae"][1])["best_val"]
    with open(os.path.join(run, "train.log")) as f:
        assert "resumed from epoch 2" in f.read()
    assert not os.path.exists(os.path.join(str(tmp_path), "port_nsvae_runs"))
    vae_ini = os.path.join(runs["root"], "port_clean.ini")
    for main, cfg in ((t_vae, vae_ini), (t_nsvae, ini)):
        with pytest.raises(SystemExit, match="reload_savedir"):
            main(["--cfg_file", cfg, "--device", "cpu", "--reload"])


def test_train_nsvae_refuses_a_dir_without_best(runs, tmp_path):
    from idccrn_vae_torch.cli.train_nsvae import main

    empty = str(tmp_path / "empty_run")
    os.makedirs(empty)
    ini = _nsvae_ini(str(tmp_path), "port", runs["dirs"], empty,
                     runs["port_noise"][1])
    with pytest.raises(SystemExit, match="no 'best' snapshot"):
        main(["--cfg_file", ini, *NSVAE_FLAGS, "--device", "cpu"])
    assert not os.path.exists(os.path.join(str(tmp_path), "port_nsvae_runs"))


def test_train_cli_refuses_data_parallel(runs, tmp_path, monkeypatch):
    """--n_devices 2 without a card and without --device cpu raises
    before any data is read (here before the ini, which does not exist);
    with --device cpu, train_vae trains on two Gloo ranks, and rank 0
    alone writes the run dir (its trajectory is held against JAX's mesh
    in tests/test_torch_port_parallel_cli.py)."""
    from idccrn_vae_torch.cli.train_vae import main

    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["--cfg_file", str(tmp_path / "missing.ini"),
              "--n_devices", "2"])
    saved = str(tmp_path / "runs")
    ini = _ini(str(tmp_path / "dp.ini"), saved, "clean_vae",
               {"train_data_dir": runs["dirs"]["clean_train"],
                "val_data_dir": runs["dirs"]["clean_val"]})
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    curves, best, run_dir = main(["--cfg_file", ini, *FLAGS, "--device",
                                  "cpu", "--n_devices", "2"])
    assert run_dir == _run_dir(saved)
    _finite_curves(curves, 2)
    assert sorted(os.listdir(run_dir)) == RUN_FILES
    with open(os.path.join(run_dir, "train.log")) as f:
        log = f.read()
    assert log.count("data-parallel world 2") == 1, log
    assert _meta(run_dir)["best_val"] == best


def test_host_modules_match_jax(runs, tmp_path):
    """The copied host modules against the JAX package's: stats files
    byte for byte and the datanorm read from an ini, the ini surface,
    and the BatchLoader's batches for a seed and epoch."""
    from idccrn_vae_torch.cli import common as tcommon
    from idccrn_vae_torch.data import loader as tloader
    from idccrn_vae_torch.data import segments as tseg
    from idccrn_vae_torch.data import stats as tstats
    from idccrn_vae_torch.utils import config as tconfig
    from idccrn_vae_tpu.cli import common as jcommon
    from idccrn_vae_tpu.data import loader as jloader
    from idccrn_vae_tpu.data import segments as jseg
    from idccrn_vae_tpu.data import stats as jstats
    from idccrn_vae_tpu.utils import config as jconfig

    rng = np.random.default_rng(3)
    arr = rng.standard_normal((257, 2)).astype(np.float32)
    paths = {}
    for side, mod in (("t", tstats), ("j", jstats)):
        paths[side] = [str(tmp_path / f"{side}_{k}.txt") for k in ("m", "s")]
        mod.save_stats_txt(paths[side][0], arr)
        mod.save_stats_txt(paths[side][1], np.abs(arr) + 1)
    for a, b in zip(paths["t"], paths["j"]):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    ini_path = tmp_path / "dn.ini"
    ini_path.write_text(f"[User]\nmean_file = {paths['t'][0]}\n"
                        f"std_file = {paths['t'][1]}\nCaseKey = 1\n")
    tini = tconfig.load_ini(str(ini_path))
    jini = jconfig.load_ini(str(ini_path))
    assert tconfig.get_opt(tini, "User", "CaseKey") == \
        jconfig.get_opt(jini, "User", "CaseKey") == "1"
    assert tconfig.get_opt(tini, "User", "missing", "d") == "d"
    got = tcommon.datanorm_from_ini(tini, True)
    want = jcommon.datanorm_from_ini(jini, True)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    assert tcommon.datanorm_from_ini(tini, False) is None

    dirs = runs["dirs"]
    files = tseg.find_wavs(dirs["noisy_train"])
    index = tseg.build_segment_index(files, 17, 100, 16000, trim=True)
    assert index == jseg.build_segment_index(files, 17, 100, 16000, trim=True)
    batches = []
    for seg, ldr in ((tseg, tloader), (jseg, jloader)):
        ds = seg.SegmentDataset(index, "triplet", dirs["clean_train"],
                                dirs["noise_train"])
        loader = ldr.BatchLoader(ds, 3, seed=5, num_threads=2)
        loader.set_epoch(4)
        batches.append(list(loader))
    assert len(batches[0]) == len(batches[1]) == len(index) // 3
    for got, want in zip(*batches):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
