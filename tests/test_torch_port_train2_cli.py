"""The port's second set of training CLIs end to end on the CPU:
`cal_mean_std` over the noisy train split, `train_supervised --data_norm`
with those statistics, `train_phase2` classical (both decoders, the
decoder started from the CVAE run with `--load_de`) and `--adversarial`,
then `test_enhance --phase 2` and `test_supervised` on their run dirs,
all with `--device cpu` on a tiny synthetic corpus and inis the test
writes. The port's CVAE and NSVAE runs come from its own `train_vae` and
`train_nsvae`.

The JAX CLIs run once each on the same inis and flags, the JAX
`train_phase2` from a JAX NSVAE dir written with the port run's meta.json
(its weights are JAX's own init): the port's meta.json has their keys,
configs and counters. What is compared is what the CLIs and their `fit`
write around the steps, so the JAX trainers' steps are replaced by one
that returns the state and constant metrics (compiling the real ones
takes minutes on a loaded CPU), and the JAX supervised model's init,
which takes ~40 s here, by a one-leaf state. The steps themselves are
held against the JAX trainers in tests/test_torch_port_phase2.py and
test_torch_port_supervised_train.py.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_util import finite_curves, run_dir, train_ini

VAE_FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--num_samples", "1",
             "--causal", "--skip_padding", "--kl_weight", "0.01"]
NSVAE_FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--causal",
               "--latent_num", "2", "--nsvae_model", "original"]
PHASE2_FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--causal",
                "--use_sc_phase2", "--recon_type", "mask", "--num_samples",
                "1"]
CLASSICAL = ["--latent_num", "2", "--load_de"]
ADVERSARIAL = ["--adversarial", "--dlr", "1e-3", "--d_step", "2"]
SUPERVISED_FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--causal",
                    "--recon_type", "mask", "--data_norm"]
RUN_FILES = ["best.pt", "loss_curves.json", "meta.json", "state.pt",
             "train.log"]
CPU = ["--device", "cpu"]


def _triplet_user(dirs):
    return {f"{k}_{s}_data_dir": dirs[f"{k}_{s}"]
            for k in ("noisy", "clean", "noise") for s in ("train", "val")}


def _phase2_ini(root, side, dirs, epochs=2, kind="classical"):
    return train_ini(os.path.join(root, f"{side}_{kind}_{epochs}.ini"),
                     os.path.join(root, f"{side}_{kind}_runs"),
                     "phase2_decoder", _triplet_user(dirs), epochs)


def _constant_step(self, state, *args, **kwargs):
    """Stands in for a JAX trainer's `_step`: the state as it was, and
    every metric a fit reads."""
    return state, {"total": jnp.float32(1.0), "recon_sisnr": jnp.float32(1.0)}


def _one_leaf_state(self, rng=None):
    """Stands in for the JAX supervised trainer's `init_state`."""
    leaf = {"w": jnp.zeros(1)}
    return {"model": {"params": leaf, "stats": leaf}, "opt": leaf}


def _write_jax_nsvae_dir(path, meta):
    """A JAX NSVAE checkpoint dir with the port run's meta.json and the
    JAX noisy encoder's own init as its best snapshot (the one entry
    train_phase2 reads)."""
    from idccrn_vae_tpu.cli.common import config_from_meta
    from idccrn_vae_tpu.models.nsvae import NsvaeEncoder
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager

    noisy = config_from_meta(meta, "noisy_config")
    ckpt = CheckpointManager(path)
    ckpt.save_meta(meta)
    ckpt.save_best({"noisy_enc": NsvaeEncoder(noisy).init(
        jax.random.PRNGKey(0))})
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run of the recipe on both sides (see the module docstring)."""
    from idccrn_vae_torch.cli import cal_mean_std as t_stats
    from idccrn_vae_torch.cli import train_nsvae as t_nsvae
    from idccrn_vae_torch.cli import train_phase2 as t_phase2
    from idccrn_vae_torch.cli import train_supervised as t_sup
    from idccrn_vae_torch.cli import train_vae as t_vae
    from idccrn_vae_torch.data.synth import make_corpus
    from idccrn_vae_tpu.cli import cal_mean_std as j_stats
    from idccrn_vae_tpu.cli import train_phase2 as j_phase2
    from idccrn_vae_tpu.cli import train_supervised as j_sup
    from idccrn_vae_tpu.train.phase2 import Phase2Trainer
    from idccrn_vae_tpu.train.supervised import SupervisedTrainer

    root = str(tmp_path_factory.mktemp("train2_cli"))
    dirs, _ = make_corpus(os.path.join(root, "corpus"), 4, 2,
                          utt_seconds=0.5, seed=17)
    out = {"root": root, "dirs": dirs}
    ini = train_ini(os.path.join(root, "cvae.ini"),
                    os.path.join(root, "cvae_runs"), "cvae",
                    {"train_data_dir": dirs["clean_train"],
                     "val_data_dir": dirs["clean_val"]}, epochs=1)
    out["cvae"] = t_vae.main(["--cfg_file", ini, "--first_use_dataset",
                              *VAE_FLAGS, *CPU])[2]
    user = dict(_triplet_user(dirs), pre_clean_encoder=out["cvae"],
                pre_noise_encoder=out["cvae"])
    ini = train_ini(os.path.join(root, "nsvae.ini"),
                    os.path.join(root, "nsvae_runs"), "nsvae", user, epochs=1)
    out["nsvae"] = t_nsvae.main(["--cfg_file", ini, "--first_use_dataset",
                                 *NSVAE_FLAGS, *CPU])[2]

    for side, main, extra in (("port", t_stats.main, CPU),
                              ("jax", j_stats.main, [])):
        stats = [os.path.join(root, f"{side}_{k}.txt") for k in ("mean", "std")]
        main(["--data_dir", dirs["noisy_train"], "--mean_out", stats[0],
              "--std_out", stats[1], "--no_trim", *extra])
        out[f"{side}_stats"] = stats

    with pytest.MonkeyPatch.context() as patch:
        for trainer in (Phase2Trainer, SupervisedTrainer):
            patch.setattr(trainer, "_step", _constant_step)
        patch.setattr(SupervisedTrainer, "init_state", _one_leaf_state)
        mean, std = out["port_stats"]
        for side, main, extra in (("port", t_sup.main, CPU),
                                  ("jax", j_sup.main, [])):
            ini = train_ini(os.path.join(root, f"{side}_sup.ini"),
                            os.path.join(root, f"{side}_sup_runs"),
                            "supervised_dccrn",
                            dict(_triplet_user(dirs), mean_file=mean,
                                 std_file=std))
            res = main(["--cfg_file", ini, "--first_use_dataset",
                        *SUPERVISED_FLAGS, *extra])
            out[f"{side}_supervised"] = (res, run_dir(
                os.path.join(root, f"{side}_sup_runs")))

        jax_nsvae = _write_jax_nsvae_dir(
            os.path.join(root, "jax_nsvae"),
            json.load(open(os.path.join(out["nsvae"], "meta.json"))))
        for kind, flags in (("classical", CLASSICAL), ("adversarial",
                                                       ADVERSARIAL)):
            ini = _phase2_ini(root, "port", dirs, kind=kind)
            load = (["--pre_decoder_dir", out["cvae"]] if kind == "classical"
                    else [])
            res = t_phase2.main(["--cfg_file", ini, "--first_use_dataset",
                                 "--first_phase_folder", out["nsvae"],
                                 *PHASE2_FLAGS, *flags, *load, *CPU])
            out[f"port_{kind}"] = (res, res[2])
            ini = _phase2_ini(root, "jax", dirs, kind=kind)
            # the JAX run starts its decoder from its own init (no JAX CVAE)
            j_phase2.main(["--cfg_file", ini, "--first_use_dataset",
                           "--first_phase_folder", jax_nsvae, *PHASE2_FLAGS,
                           *[f for f in flags if f != "--load_de"]])
            out[f"jax_{kind}"] = (None, run_dir(
                os.path.join(root, f"jax_{kind}_runs")))
    return out


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def test_cal_mean_std_cli_matches_jax(runs):
    """The two CLIs' text files hold the same statistics (to 1e-6 of
    their largest value)."""
    from idccrn_vae_torch.data.stats import load_stats_txt

    got = load_stats_txt(*runs["port_stats"])
    want = load_stats_txt(*runs["jax_stats"])
    for g, w in zip(got, want):
        assert g.shape == w.shape == (257, 2)
        assert np.abs(g - w).max() <= 1e-6 * np.abs(w).max()
        assert np.isfinite(g).all()
    assert (got[1] >= 0).all() and got[1].max() > 0


BEST_KEYS = {"classical": ["decoder", "encoder", "noise_decoder"],
             "adversarial": ["decoder", "dis", "encoder"]}


@pytest.mark.parametrize("kind", ["supervised", "classical", "adversarial"])
def test_train_cli_writes_a_run_dir(runs, kind):
    """Two epochs, finite losses, the run dir's files, the epoch counter,
    loss_curves.json as returned, and what best.pt holds: a bare
    state_dict for the supervised model, and encoder, decoder(s) and D
    for phase 2 (--load_de started the decoder from the CVAE run)."""
    from idccrn_vae_torch.train.checkpoint import CheckpointManager

    (curves, best, path), saved = runs[f"port_{kind}"]
    assert path == saved
    finite_curves(curves, 2)
    assert np.isfinite(best)
    assert sorted(os.listdir(path)) == RUN_FILES
    meta = _meta(path)
    assert meta["epoch"] == 1 and meta["best_val"] == best
    with open(os.path.join(path, "loss_curves.json")) as f:
        assert json.load(f) == curves
    snapshot = CheckpointManager(path).load_best()
    if kind == "supervised":
        assert all(k.startswith("std_DCCRN.") for k in snapshot)
        assert meta["datanorm"] is not None
        return
    assert sorted(snapshot) == BEST_KEYS[kind]
    if kind == "adversarial":
        assert "dis" in curves["train"][0] and "dis" in curves["val"][0]
        assert best == min(row["recon_sisnr"] for row in curves["val"])
        return
    # the NSVAE run's noisy encoder, frozen through the fine-tune
    noisy = CheckpointManager(runs["nsvae"]).load_best()["noisy_enc"]
    assert all(np.array_equal(snapshot["encoder"][k], v)
               for k, v in noisy.items())
    cvae = CheckpointManager(runs["cvae"]).load_best()["dec"]
    assert sorted(snapshot["decoder"]) == sorted(cvae)


@pytest.mark.parametrize("kind", ["supervised", "classical", "adversarial"])
def test_meta_has_the_jax_cli_keys(runs, kind):
    """The same flags and inis give the JAX CLIs' meta.json keys,
    configs, scheduler state keys and counters (best_val, patience and
    the schedulers' values follow each side's own weights)."""
    got = _meta(runs[f"port_{kind}"][1])
    want = _meta(runs[f"jax_{kind}"][1])
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if key.startswith("sched"):
            assert sorted(got[key]) == sorted(value), key
        elif key not in ("best_val", "patience"):
            assert got[key] == value, key


@pytest.mark.parametrize("kind", ["classical", "adversarial"])
def test_test_enhance_phase2_reads_the_run(runs, tmp_path, kind):
    """The port's test_enhance --phase 2 serves a port phase-2 run dir:
    encoder and fine-tuned decoder(s) from best.pt, configs from
    meta.json; every score finite."""
    from idccrn_vae_torch.cli.test_enhance import main

    dirs = runs["dirs"]
    res = main(["--nsvae_dir", runs[f"port_{kind}"][1], "--phase", "2",
                "--noisy_dir", dirs["noisy_val"], "--clean_dir",
                dirs["clean_val"], "--out_dir", str(tmp_path / "eval"),
                "--num_samples", "2", "--compute", "f32", *CPU])
    per = res["per_utterance"]
    assert len(per) == 2
    assert all(np.isfinite(list(v.values())).all() for v in per.values())


@pytest.mark.parametrize("model_type", ["checkpoint", "final"])
def test_test_supervised_reads_the_run(runs, tmp_path, model_type):
    """test_supervised on the train_supervised run: best.pt or state.pt's
    model, with the datanorm rebuilt from meta.json."""
    from idccrn_vae_torch.cli.test_supervised import main

    dirs = runs["dirs"]
    res = main(["--model_dir", runs["port_supervised"][1], "--model_type",
                model_type, "--noisy_dir", dirs["noisy_val"], "--clean_dir",
                dirs["clean_val"], "--out_dir", str(tmp_path / "eval"),
                *CPU])
    per = res["per_utterance"]
    assert len(per) == 2
    assert all(np.isfinite(list(v.values())).all() for v in per.values())


def test_reload_resumes_the_adversarial_run(runs, tmp_path):
    """--reload with one more epoch runs epoch 2 only; batch_counter
    carries on from the saved run (d_step 2)."""
    from idccrn_vae_torch.cli.train_phase2 import main

    run = str(tmp_path / "resumed")
    shutil.copytree(runs["port_adversarial"][1], run)
    before = _meta(run)
    n_batches = before["batch_counter"] // 2
    ini = _phase2_ini(str(tmp_path), "port", runs["dirs"], epochs=3,
                      kind="adversarial")
    curves, _, path = main(["--cfg_file", ini, "--first_phase_folder",
                            runs["nsvae"], *PHASE2_FLAGS, *ADVERSARIAL,
                            *CPU, "--reload", "--reload_savedir", run])
    assert path == run
    finite_curves(curves, 1)
    meta = _meta(run)
    assert meta["epoch"] == 2 and meta["batch_counter"] == 3 * n_batches
    assert meta["sched_dis"].keys() == before["sched_dis"].keys()
    with open(os.path.join(run, "train.log")) as f:
        assert "resumed from epoch 2" in f.read()
    assert not os.path.exists(str(tmp_path / "port_adversarial_runs"))


def test_train_phase2_refusals(runs, tmp_path, monkeypatch):
    """Refused before any run dir is made: --load_de without
    --pre_decoder_dir, a --first_phase_folder without meta.json (no dir
    is made there either) or without a best snapshot, also with
    --n_devices 2 (ahead of starting any rank). --n_devices 2 without a
    card and without --device cpu raises before any data is read in both
    training CLIs; with --device cpu, train_supervised trains on two Gloo
    ranks."""
    from idccrn_vae_torch.cli.train_phase2 import main
    from idccrn_vae_torch.cli.train_supervised import main as sup_main

    ini = _phase2_ini(str(tmp_path), "port", runs["dirs"])
    argv = ["--cfg_file", ini, *PHASE2_FLAGS, *CPU]
    with pytest.raises(SystemExit, match="pre_decoder_dir"):
        main([*argv, "--first_phase_folder", runs["nsvae"], "--load_de"])
    missing = str(tmp_path / "no_such_run")
    with pytest.raises(SystemExit, match="meta.json missing"):
        main([*argv, "--first_phase_folder", missing])
    assert not os.path.exists(missing)
    no_best = str(tmp_path / "no_best")
    os.makedirs(no_best)
    shutil.copy(os.path.join(runs["nsvae"], "meta.json"), no_best)
    with pytest.raises(SystemExit, match="no best snapshot"):
        main([*argv, "--first_phase_folder", no_best])
    assert not os.path.exists(str(tmp_path / "port_classical_runs"))
    with pytest.raises(SystemExit, match="no best snapshot"):
        main([*argv, "--first_phase_folder", no_best, "--n_devices", "2"])
    no_card = ["--cfg_file", ini, *PHASE2_FLAGS, "--n_devices", "2"]
    with pytest.raises(RuntimeError, match="CUDA device"):
        main([*no_card, "--first_phase_folder", runs["nsvae"]])
    with pytest.raises(RuntimeError, match="CUDA device"):
        sup_main(["--cfg_file", ini, "--n_devices", "2"])
    assert not os.path.exists(str(tmp_path / "port_classical_runs"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    flags = [f for f in SUPERVISED_FLAGS if f != "--data_norm"]
    curves, _, run = sup_main(["--cfg_file", ini, *flags, *CPU,
                               "--n_devices", "2"])
    finite_curves(curves, 2)
    with open(os.path.join(run, "train.log")) as f:
        assert f.read().count("data-parallel world 2") == 1
