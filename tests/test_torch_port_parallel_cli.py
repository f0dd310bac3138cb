"""The port's data-parallel CLIs on the CPU (`--device cpu --n_devices
2`, two Gloo ranks) against the JAX CLIs on a 2-device mesh
(`--n_devices 2`) and against the port's own single-process runs.

train_vae: a JAX run trains one epoch on the 2-device mesh; its dir is
converted (port_tools/convert_jax_checkpoint.py), and each side resumes
its copy for the second epoch with `--n_devices 2`, both with the same
latent draws of the global batch (`FixedNoise` on the JAX side; each
port rank keeps its rows of the same draws, `torch_port_ranks.
patch_noise`). The port's ranks run in one group that the test spawns,
so that each can take the patch; the CLI's own spawn is exercised by
tests/test_torch_port_train_cli.py and below. The resumed epoch's
loss_curves.json and the meta.json are held as tests/
test_torch_port_convert.py holds them (every metric to 1e-3 relative,
the SI-SNR loss to its conditioning bound, see that file), and rank 0
alone writes the run dir: one train.log line per event.

test_enhance at a batch of 3 utterances, which two ranks split as 2 + 2
with one pad row:
  * `--n_devices 2` (the CLI's own spawn, the ranks drawing from the
    generator) against `--n_devices 1`: the per-utterance JSON and the
    wavs equal (float scores to 1e-6, wav samples bit for bit);
  * `--n_devices 2` against the JAX CLI's `--n_devices 2`, both handed
    the same draws for the 3 real rows (zeros for the pad row): the JSON
    scores within 1e-3 and the wavs within one PCM16 step, the
    tolerance of tests/test_torch_port_cli.py;
  * only the JSON files and the wav dir are written, once.
"""

import datetime
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_port_ranks as ranks
from idccrn_vae_torch.parallel import distributed
from torch_port_util import (
    FixedNoise,
    assert_json_close,
    assert_wavs_within_lsb,
    configs,
    np_vars,
    patch_jax_noise,
    read_json,
    run_dir,
    train_ini,
    write_test_set,
)

TIMEOUT = datetime.timedelta(seconds=60)
FIT_REL = 1e-3
SEED = 11
FLAGS = ["--zdim", "4", "--encoder_dim_start", "2", "--num_samples", "2",
         "--causal", "--skip_padding", "--kl_weight", "0.01",
         "--mi_weight", "0.2", "--recon_loss_weight", "1.0,1.0,0.0",
         "--n_devices", "2"]
LENGTHS = (25000, 9900, 12000)


def _spawn(cli, argv, noise):
    return distributed.spawn(ranks.cli_main, 2, args=(cli, argv, noise),
                             device="cpu", timeout=TIMEOUT,
                             deadline=TIMEOUT.total_seconds())


@pytest.fixture(scope="module")
def vae_runs(tmp_path_factory):
    from idccrn_vae_torch.data.synth import make_corpus
    from idccrn_vae_tpu.cli.train_vae import main as j_main
    from port_tools.convert_jax_checkpoint import convert

    root = str(tmp_path_factory.mktemp("dp_cli"))
    dirs, _ = make_corpus(os.path.join(root, "corpus"), 4, 2,
                          utt_seconds=0.3, seed=SEED)
    user = {"train_data_dir": dirs["clean_train"],
            "val_data_dir": dirs["clean_val"]}
    ini1 = train_ini(os.path.join(root, "e1.ini"),
                     os.path.join(root, "jax_runs"), "clean_vae", user, 1)
    ini2 = train_ini(os.path.join(root, "e2.ini"),
                     os.path.join(root, "unused"), "clean_vae", user, 2)
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_noise(mp, FixedNoise(SEED),
                        module="idccrn_vae_tpu.models.vae")
        j_main(["--cfg_file", ini1, "--first_use_dataset", *FLAGS])
        jdir = run_dir(os.path.join(root, "jax_runs"))
        tdir = convert(jdir, os.path.join(root, "port_run"))
        jres = os.path.join(root, "jax_resumed")
        shutil.copytree(jdir, jres)
        j_main(["--cfg_file", ini2, "--reload", "--reload_savedir", jres,
                *FLAGS])
        mp.setenv("OMP_NUM_THREADS", "1")
        res = _spawn("train_vae", ["--cfg_file", ini2, "--reload",
                                   "--reload_savedir", tdir, *FLAGS,
                                   "--device", "cpu"], ("vae", SEED))
    return {"jres": jres, "tdir": tdir, "res": res}


def test_train_vae_two_ranks_resume_as_the_jax_mesh(vae_runs):
    curves, best, out_dir = vae_runs["res"]
    tdir, jres = vae_runs["tdir"], vae_runs["jres"]
    assert out_dir == tdir
    tc = read_json(tdir, "loss_curves.json")
    jc = read_json(jres, "loss_curves.json")
    assert tc == json.loads(json.dumps(curves))
    worst = 0.0
    for split in ("train", "val"):
        assert len(tc[split]) == len(jc[split]) == 1  # the resumed epoch
        got, want = tc[split][0], jc[split][0]
        assert set(got) == set(want)
        for k in want:
            if k == "sisnr":  # see tests/test_torch_port_convert.py
                r = 10 ** (-want[k] / 10)
                tol = 20 * math.log10(1 + FIT_REL / math.sqrt(r / (1 + r)))
                assert abs(got[k] - want[k]) <= tol, (split, got[k], want[k])
                continue
            worst = max(worst, abs(got[k] - want[k])
                        / max(abs(want[k]), 1e-6))
    assert worst <= FIT_REL, f"worst resumed-epoch metric rel err {worst:.3e}"
    tmeta, jmeta = read_json(tdir, "meta.json"), read_json(jres, "meta.json")
    assert sorted(tmeta) == sorted(jmeta)
    assert tmeta["epoch"] == jmeta["epoch"] == 1
    for k in ("sched_en", "sched_de"):
        assert tmeta[k]["num_bad"] == jmeta[k]["num_bad"], k
    assert tmeta["best_val"] == pytest.approx(jmeta["best_val"], rel=FIT_REL)
    assert best == tmeta["best_val"]
    # rank 0 alone writes the run dir
    assert sorted(os.listdir(tdir)) == ["best.pt", "loss_curves.json",
                                        "meta.json", "state.pt", "train.log"]
    with open(os.path.join(tdir, "train.log")) as f:
        log = f.read()
    assert log.count("data-parallel world 2") == 1, log
    assert log.count("resumed from epoch 1") == 1, log


def _phase2_dirs(root):
    """A phase-2 checkpoint (NSVAE encoder and decoder, JAX init) as a JAX
    dir and its conversion to a port dir."""
    from idccrn_vae_tpu.models.nsvae import NsvaeEncoder
    from idccrn_vae_tpu.models.vae import VaeDecoder
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager
    from port_tools.convert_jax_checkpoint import convert

    import dataclasses

    enc, _ = configs()
    dec, _ = configs()
    jdir = os.path.join(root, "j_phase2")
    ckpt = CheckpointManager(jdir)
    ckpt.save_meta({"enc_config": dataclasses.asdict(enc),
                    "dec_config": dataclasses.asdict(dec),
                    "adversarial": False})
    ckpt.save_best({
        "encoder": np_vars(NsvaeEncoder(enc).init(jax.random.PRNGKey(8))),
        "decoder": np_vars(VaeDecoder(dec).init(jax.random.PRNGKey(9)))})
    return jdir, convert(jdir, os.path.join(root, "t_phase2"))


def _jax_padded_draws(monkeypatch, real_rows):
    """The JAX encoder's draws: FixedNoise(SEED) for the real rows, zeros
    for the mesh's pad rows (the port ranks' `patch_noise`)."""
    from idccrn_vae_tpu.models.reparam import reparameterize

    def fixed(rng, g, num_samples, guard="eps", noise=None):
        b, t, h = g.mu_r.shape
        pad = jnp.zeros((b - real_rows, num_samples, t, h), jnp.float32)
        eps = tuple(jnp.concatenate([jnp.asarray(e), pad]) for e in
                    FixedNoise(SEED)(real_rows, num_samples, t, h))
        return reparameterize(rng, g, num_samples, guard=guard, noise=eps)

    monkeypatch.setattr("idccrn_vae_tpu.models.nsvae.reparameterize", fixed)


def _outputs(out_dir):
    return sorted(os.listdir(out_dir))


def test_test_enhance_two_ranks_match_one_rank_and_the_jax_mesh(
        tmp_path, monkeypatch):
    from idccrn_vae_torch.cli.test_enhance import main as t_main
    from idccrn_vae_tpu.cli.test_enhance import main as j_main

    noisy, clean, _ = write_test_set(tmp_path / "data", LENGTHS, seed=3)
    names = sorted(os.path.basename(p) for p in noisy)
    jdir, tdir = _phase2_dirs(str(tmp_path))
    common = ["--phase", "2", "--noisy_dir", os.path.dirname(noisy[0]),
              "--clean_dir", os.path.dirname(clean[0]), "--num_samples",
              "2", "--compute", "f32", "--write_wavs"]
    out = {k: str(tmp_path / k) for k in ("one", "two", "jax", "two_fixed")}
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    port = ["--nsvae_dir", tdir, "--device", "cpu", *common]
    res1 = t_main([*port, "--out_dir", out["one"]])
    res2 = t_main([*port, "--out_dir", out["two"], "--n_devices", "2"])
    assert _outputs(out["two"]) == _outputs(out["one"]) == [
        "enhanced", "log.txt", "noisy_per_utterance.json",
        "per_utterance.json", "summary.json"]
    assert_json_close(res2["per_utterance"], res1["per_utterance"], 1e-6,
                      "per_utterance")
    for f in ("per_utterance.json", "noisy_per_utterance.json"):
        assert_json_close(read_json(out["two"], f), read_json(out["one"], f),
                          1e-6, f)
    from idccrn_vae_torch.data.audio_io import read_wav

    for name in names:
        a, _ = read_wav(os.path.join(out["two"], "enhanced", name))
        b, _ = read_wav(os.path.join(out["one"], "enhanced", name))
        np.testing.assert_array_equal(a, b, err_msg=name)
    # against the JAX CLI's mesh, from the same draws
    _jax_padded_draws(monkeypatch, len(LENGTHS))
    j_main(["--nsvae_dir", jdir, *common, "--out_dir", out["jax"],
            "--n_devices", "2"])
    _spawn("test_enhance", [*port, "--out_dir", out["two_fixed"],
                            "--n_devices", "2"],
           ("nsvae", SEED, len(LENGTHS)))
    for f in ("per_utterance.json", "noisy_per_utterance.json"):
        assert_json_close(read_json(out["two_fixed"], f),
                          read_json(out["jax"], f), 1e-3, f)
    assert_wavs_within_lsb(os.path.join(out["two_fixed"], "enhanced"),
                           os.path.join(out["jax"], "enhanced"), names)
