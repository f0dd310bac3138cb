"""The port's evaluation CLIs against the JAX CLIs on the CPU.

Each family's weights are written twice from the same JAX variables: as
a JAX checkpoint dir (the JAX `CheckpointManager`: meta.json + orbax)
and as a port checkpoint dir (meta.json + best.pt / state.pt, holding
the port state_dicts `load_jax_variables` gives). Both CLIs run on the
same test set, the port with `--device cpu`, and their outputs are
compared: with the same injected latent noise for `test_enhance` and
`test_prevae` (JSON scores within 1e-3, wavs within one PCM16 step), and
wavs within one PCM16 step for the deterministic `test_supervised` and
`stream_enhance`.

The JAX CLIs draw their latent noise once per traced batch shape; at the
CLIs' default batch size the test set is one batch, so both sides draw
once, in the same order (tests/test_torch_port_runners.py holds the
runners' multi-batch order).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from idccrn_vae_torch.cli import common as tcommon
from idccrn_vae_torch.models.dccrn import SupervisedDccrn
from idccrn_vae_torch.models.from_jax import jax_to_state_dict
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder
from idccrn_vae_torch.train.checkpoint import CheckpointManager as TorchCkpt
from idccrn_vae_torch.train.checkpoint import datanorm_to_meta
from idccrn_vae_tpu.cli import common as jcommon
from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JaxSupervised
from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_tpu.models.vae import VaeEncoder as JaxVaeEncoder
from idccrn_vae_tpu.train.checkpoint import CheckpointManager as JaxCkpt
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
LENGTHS = (25000, 9900, 12000)
PORT_MODULES = {JaxEncoder: NsvaeEncoder, JaxDecoder: VaeDecoder,
                JaxVaeEncoder: VaeEncoder, JaxSupervised: SupervisedDccrn}


def _init(model_cls, jc, seed, dn=None):
    """(JAX variables, port state_dict) of one model, the same weights."""
    port_cfg = tcommon.config_from_meta({"config": _asdict(jc)})
    variables = np_vars((model_cls(jc, dn) if dn is not None
                         else model_cls(jc)).init(jax.random.PRNGKey(seed)))
    port_cls = PORT_MODULES[model_cls]
    module = (port_cls(port_cfg, dn, device="cpu") if dn is not None
              else port_cls(port_cfg, device="cpu"))
    return variables, load_jax_variables(module, variables).state_dict()


def _save_both(root, name, meta, best):
    """Write `best` = {key: (JAX vars, port state_dict)}, or one such pair
    for a bare snapshot, as a JAX checkpoint dir under root/j/name, and
    the port's dir under root/t/name made from it by
    port_tools/convert_jax_checkpoint.py; the port state_dicts of `best`
    must equal what the converter wrote."""
    from port_tools.convert_jax_checkpoint import convert

    jdir = os.path.join(str(root), "j", name)
    ckpt = JaxCkpt(jdir)
    ckpt.save_meta(meta)
    pick = lambda tree, side: (tree[side] if isinstance(tree, tuple)
                               else {k: v[side] for k, v in tree.items()})
    ckpt.save_best(pick(best, 0))
    tdir = convert(jdir, os.path.join(str(root), "t", name))
    got, want = TorchCkpt(tdir).load_best(), pick(best, 1)
    for sd_got, sd_want in ([(got, want)] if isinstance(best, tuple) else
                            ((got[k], want[k]) for k in want)):
        assert sorted(sd_got) == sorted(sd_want)
        for k in sd_want:
            assert torch.equal(sd_got[k], sd_want[k]), k
    return [jdir, tdir]


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    noisy, clean, meta = write_test_set(root, LENGTHS, seed=3)
    return {"noisy": os.path.dirname(noisy[0]),
            "clean": os.path.dirname(clean[0]), "meta": meta,
            "names": sorted(os.path.basename(p) for p in noisy)}


def _phase1_dirs(root, dual: bool):
    """(nsvae dirs, cvae dirs, nvae dirs or None), each (JAX, port)."""
    pre, _ = configs()
    noisy = (configs(latent_num=2, channel_mode="double")[0] if dual
             else pre)
    cvae = _save_both(root, "cvae", {"config": _asdict(pre),
                                     "datanorm": None},
                      {"enc": _init(JaxVaeEncoder, pre, 1),
                       "dec": _init(JaxDecoder, pre, 2)})
    nvae = (_save_both(root, "nvae", {"config": _asdict(pre),
                                      "datanorm": None},
                       {"enc": _init(JaxVaeEncoder, pre, 3),
                        "dec": _init(JaxDecoder, pre, 4)})
            if dual else None)
    nsvae = _save_both(root, "nsvae",
                       {"pre_config": _asdict(pre),
                        "noisy_config": _asdict(noisy), "epoch": 3},
                       {"clean_enc": _init(JaxVaeEncoder, pre, 5),
                        "noise_enc": _init(JaxVaeEncoder, pre, 6),
                        "noisy_enc": _init(JaxEncoder, noisy, 7)})
    return nsvae, cvae, nvae


def _phase2_dirs(root):
    enc, _ = configs(latent_num=2, channel_mode="double")
    dec, _ = configs()
    return _save_both(root, "phase2",
                      {"enc_config": _asdict(enc), "dec_config": _asdict(dec),
                       "adversarial": False},
                      {"encoder": _init(JaxEncoder, enc, 8),
                       "decoder": _init(JaxDecoder, dec, 9),
                       "noise_decoder": _init(JaxDecoder, dec, 10)})


def _compare_eval_dirs(got, want, names, wav_dir):
    for f in sorted(os.listdir(want)):
        if f.endswith(".json"):
            assert_json_close(read_json(got, f), read_json(want, f),
                              SCORE_ATOL, f)
    assert sorted(f for f in os.listdir(got) if f.endswith(".json")) == \
        sorted(f for f in os.listdir(want) if f.endswith(".json"))
    assert_wavs_within_lsb(os.path.join(got, wav_dir),
                           os.path.join(want, wav_dir), names)


@pytest.mark.parametrize("case", ["phase1", "phase1_dual", "phase2"])
def test_test_enhance_matches_jax(tmp_path, monkeypatch, data, case):
    from idccrn_vae_torch.cli.test_enhance import main as t_main
    from idccrn_vae_tpu.cli.test_enhance import main as j_main

    if case == "phase2":
        nsvae = _phase2_dirs(tmp_path)
        flags = [["--phase", "2"]] * 2
        extra = ["--latent_to_use", "2", "--outtype", "phase_mask"]
    else:
        nsvae, cvae, nvae = _phase1_dirs(tmp_path, case == "phase1_dual")
        flags = [["--decoder_dir", d] for d in cvae]
        extra = []
        if nvae is not None:
            flags = [f + ["--noise_decoder_dir", d]
                     for f, d in zip(flags, nvae)]
            extra = ["--latent_to_use", "2", "--outtype", "real_imag_mask",
                     "--latent_diag"]
    common = ["--noisy_dir", data["noisy"], "--clean_dir", data["clean"],
              "--num_samples", "2", "--compute", "f32",
              "--write_wavs", "--corpus_meta", data["meta"], *extra]
    patch_jax_noise(monkeypatch, NoiseStream(4))
    patch_port_noise(monkeypatch, NoiseStream(4))
    out = [str(tmp_path / "out_j"), str(tmp_path / "out_t")]
    j_main(["--nsvae_dir", nsvae[0], *flags[0], "--out_dir", out[0],
            *common])
    res = t_main(["--nsvae_dir", nsvae[1], *flags[1], "--out_dir", out[1],
                  "--device", "cpu", *common])
    assert len(res["per_utterance"]) == len(LENGTHS)
    assert "per_snr_bucket" in res and "delta" in res
    assert ("latent_diag" in res) == (case == "phase1_dual")
    _compare_eval_dirs(out[1], out[0], data["names"], "enhanced")


def test_test_enhance_rejects_unported_modes(tmp_path, monkeypatch, data):
    """A missing decoder dir is refused before the output dir is made.
    Data-parallel evaluation (--n_devices 2) without a card and without
    --device cpu raises before any data is read; with --device cpu it
    runs on two Gloo ranks (its outputs are held against the
    single-process run and JAX's mesh in
    tests/test_torch_port_parallel_cli.py)."""
    from idccrn_vae_torch.cli.test_enhance import main as t_main

    nsvae, cvae, _ = _phase1_dirs(tmp_path, False)
    base = ["--nsvae_dir", nsvae[1], "--decoder_dir", cvae[1], "--noisy_dir",
            data["noisy"], "--clean_dir", data["clean"], "--out_dir",
            str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(RuntimeError, match="CUDA device"):
        t_main(base[:-2] + ["--n_devices", "2"])
    with pytest.raises(SystemExit, match="decoder_dir"):
        t_main(base[:2] + base[4:])
    assert not (tmp_path / "o").exists()
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    res = t_main(base + ["--n_devices", "2", "--num_samples", "2"])
    assert sorted(res["per_utterance"]) == data["names"]
    # --compute int8 serves now; at these widths no stage reaches
    # quant_min_ch 16 (tests/test_torch_port_int8.py holds the
    # quantized stages against JAX)
    res = t_main(base + ["--compute", "int8", "--num_samples", "2"])
    assert len(res["per_utterance"]) == len(LENGTHS)
    assert all(np.isfinite(list(v.values())).all()
               for v in res["per_utterance"].values())


def test_test_prevae_matches_jax(tmp_path, monkeypatch, data):
    from idccrn_vae_torch.cli.test_prevae import main as t_main
    from idccrn_vae_tpu.cli.test_prevae import main as j_main

    cfg, _ = configs(skip_mode="zero")
    dn = datanorm_stats(5)
    jdn = tuple(map(np.asarray, dn))
    dirs = _save_both(tmp_path, "vae", {"config": _asdict(cfg),
                                        "datanorm": datanorm_to_meta(dn)},
                      {"enc": _init(JaxVaeEncoder, cfg, 11, jdn),
                       "dec": _init(JaxDecoder, cfg, 12, jdn)})
    common = ["--test_dir", data["clean"], "--num_samples", "2",
              "--write_wavs"]
    patch_jax_noise(monkeypatch, NoiseStream(6),
                    module="idccrn_vae_tpu.models.vae")
    patch_port_noise(monkeypatch, NoiseStream(6),
                     module="idccrn_vae_torch.models.vae")
    out = [str(tmp_path / "out_j"), str(tmp_path / "out_t")]
    j_main(["--model_dir", dirs[0], "--out_dir", out[0], *common])
    res = t_main(["--model_dir", dirs[1], "--out_dir", out[1],
                  "--device", "cpu", *common])
    assert set(res["latent_diag"]) >= {"var_real", "var_imag",
                                      "offdiag_mean_abs_real",
                                      "offdiag_mean_abs_imag"}
    names = sorted(n.replace("noisy", "clean") for n in data["names"])
    _compare_eval_dirs(out[1], out[0], names, "recon")


def _supervised_dirs(root, cfg, dn):
    jdn = tuple(map(np.asarray, dn))
    best = _init(JaxSupervised, cfg, 13, jdn)
    final = _init(JaxSupervised, cfg, 14, jdn)
    dirs = _save_both(root, "sup", {"config": _asdict(cfg),
                                    "datanorm": datanorm_to_meta(dn)}, best)
    # state.pt in the layout each framework's test_supervised reads; it
    # holds the model only, not a trainer's state, so it is written
    # by hand on both sides
    JaxCkpt(dirs[0]).save_state({"model": final[0]})
    TorchCkpt(dirs[1]).save_state({"models": {"model": final[1]}})
    return dirs


@pytest.mark.parametrize("model_type", ["checkpoint", "final"])
def test_test_supervised_matches_jax(tmp_path, data, model_type):
    from idccrn_vae_torch.cli.test_supervised import main as t_main
    from idccrn_vae_tpu.cli.test_supervised import main as j_main

    cfg, _ = configs(recon_type="mask", lstm_hidden=8)
    dirs = _supervised_dirs(tmp_path, cfg, datanorm_stats(7))
    common = ["--noisy_dir", data["noisy"], "--clean_dir", data["clean"],
              "--batch_size", "2", "--write_wavs", "--model_type",
              model_type, "--corpus_meta", data["meta"]]
    out = [str(tmp_path / "out_j"), str(tmp_path / "out_t")]
    j_main(["--model_dir", dirs[0], "--out_dir", out[0], *common])
    res = t_main(["--model_dir", dirs[1], "--out_dir", out[1],
                  "--device", "cpu", *common])
    assert len(res["per_utterance"]) == len(LENGTHS)
    _compare_eval_dirs(out[1], out[0], data["names"], "enhanced")


@pytest.mark.parametrize("model", ["supervised", "nsvae"])
def test_stream_enhance_matches_jax(tmp_path, data, model, capsys):
    from idccrn_vae_torch.cli.stream_enhance import main as t_main
    from idccrn_vae_tpu.cli.stream_enhance import main as j_main

    if model == "supervised":
        cfg, _ = configs(recon_type="mask", lstm_hidden=8)
        dirs = _supervised_dirs(tmp_path, cfg, datanorm_stats(8))
        flags = [["--model", "supervised", "--model_dir", d] for d in dirs]
    else:
        nsvae, cvae, _ = _phase1_dirs(tmp_path, False)
        flags = [["--nsvae_dir", n, "--decoder_dir", c]
                 for n, c in zip(nsvae, cvae)]
    common = ["--in_dir", data["noisy"], "--chunk_frames", "8"]
    out = [str(tmp_path / "out_j"), str(tmp_path / "out_t")]
    want = j_main([*flags[0], "--out_dir", out[0], *common])
    got = t_main([*flags[1], "--out_dir", out[1], "--device", "cpu",
                  *common])
    assert got.keys() == want.keys()
    for k in ("files", "audio_s", "chunk_ms", "algorithmic_latency_ms"):
        assert got[k] == want[k], k
    assert got["chunk_ms"] == 50.0 and got["chunk_p95_ms"] > 0
    assert '"rtf_x"' in capsys.readouterr().out
    assert_wavs_within_lsb(out[1], out[0], data["names"])


def test_stream_enhance_rejects_bad_args(tmp_path):
    from idccrn_vae_torch.cli.stream_enhance import main as t_main

    base = ["--out_dir", str(tmp_path / "o"), "--device", "cpu"]
    with pytest.raises(SystemExit, match="exactly one"):
        t_main(["--model", "supervised", "--model_dir", str(tmp_path),
                *base])
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit, match="no wav files"):
        t_main(["--model", "supervised", "--model_dir", str(tmp_path),
                "--in_dir", str(empty), *base])
    with pytest.raises(SystemExit, match="requires --model_dir"):
        t_main(["--model", "supervised", "--in_wav", "x.wav", *base])
    with pytest.raises(SystemExit, match="requires --nsvae_dir"):
        t_main(["--in_wav", "x.wav", *base])
    assert not (tmp_path / "o").exists()


# ------------------------------------------------------------- checkpoints


def test_port_checkpoint_round_trip(tmp_path):
    cfg, tcfg = configs()
    _, enc = _init(JaxEncoder, cfg, 0)
    ckpt = TorchCkpt(str(tmp_path / "c"))
    assert not ckpt.has_best() and not ckpt.has_state()
    best = {"noisy_enc": enc, "extra": [torch.arange(3), (torch.ones(2),)]}
    state = {"model": enc, "step": 7,
             "opt": {"mu": np.linspace(0, 1, 4, dtype=np.float32)}}
    ckpt.save_best(best)
    ckpt.save_state(state)
    ckpt.save_meta({"config": cfg, "n": np.int64(3), "x": np.float32(0.5)})
    assert ckpt.has_best() and ckpt.has_state()
    assert sorted(os.listdir(ckpt.directory)) == ["best.pt", "meta.json",
                                                  "state.pt"]
    back = TorchCkpt(str(tmp_path / "c")).load_best()
    assert list(back["noisy_enc"]) == list(enc)
    for k, v in enc.items():
        assert back["noisy_enc"][k].dtype == v.dtype
        assert torch.equal(back["noisy_enc"][k], v)
    assert torch.equal(back["extra"][0], torch.arange(3))
    st = ckpt.load_state()
    assert st["step"] == 7 and torch.equal(
        st["opt"]["mu"], torch.from_numpy(state["opt"]["mu"]))
    meta = ckpt.load_meta()
    assert meta["n"] == 3 and meta["x"] == 0.5
    assert tcommon.config_from_meta(meta) == tcfg
    # a file that would run code on load is refused
    torch.save({"f": dataclasses.replace}, ckpt._path("best"))
    with pytest.raises(Exception):
        ckpt.load_best()


def test_meta_of_every_family_builds_the_port_config():
    """The tuples and every field of a JAX meta.json config come back as
    the port's DccrnConfig, for each family's config."""
    for extra in ({}, {"latent_num": 2, "channel_mode": "double"},
                  {"latent": "fc", "skip_mode": "zero", "kernel": (3, 2)},
                  {"recon_type": "mask", "lstm_hidden": 8,
                   "skip_to_use": (0, 2, 4), "causal": False}):
        jc, tc = configs(**extra)
        meta = {"config": _asdict(jc)}
        got = tcommon.config_from_meta(meta)
        assert got == tc
        assert dataclasses.asdict(got) == dataclasses.asdict(
            jcommon.config_from_meta(meta))


@pytest.mark.parametrize("kind,model_cls,extra", [
    ("nsvae_encoder", JaxEncoder, {"latent": "fc", "latent_num": 2}),
    ("vae_encoder", JaxVaeEncoder, {}),
    ("vae_decoder", JaxDecoder, {}),
    ("supervised", JaxSupervised, {"lstm_hidden": 8}),
])
def test_load_pretrained_variables_matches_jax(tmp_path, kind, model_cls,
                                               extra):
    """A reference-style .pt (a dict with `model_state_dict` and optimizer
    junk; the supervised model with its dead `linear` conv) read by both
    packages gives the same weights; a port dir is read back as saved."""
    jc, tc = configs(**extra)
    variables, sd = _init(model_cls, jc, 15)
    ref_sd = dict(sd)
    if kind == "supervised":
        ref_sd["std_DCCRN.linear.weight"] = torch.ones(1, 1, 1, 1)
    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": ref_sd, "epoch": 3,
                "optimizer_state_dict": {"lr": 1e-3}}, path)
    got = tcommon.load_pretrained_variables(path, kind, tc)
    want = jax_to_state_dict(
        np_vars(jcommon.load_pretrained_variables(path, kind, jc)),
        getattr(PORT_MODULES[model_cls], "prefix", ""))
    assert sorted(got) == sorted(want) == sorted(sd)
    for k in want:
        np.testing.assert_array_equal(got[k].reshape(-1).numpy(),
                                      want[k].reshape(-1), err_msg=k)
    del ref_sd[next(iter(sd))]
    torch.save(ref_sd, path)
    with pytest.raises(KeyError, match="lacks"):
        tcommon.load_pretrained_variables(path, kind, tc)
    d = str(tmp_path / "dir")
    TorchCkpt(d).save_best({"enc": sd})
    back = tcommon.load_pretrained_variables(d, kind, tc, which="enc")
    assert all(torch.equal(back[k], sd[k]) for k in sd)
