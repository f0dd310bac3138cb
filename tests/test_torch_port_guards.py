"""Guards around the port: it imports neither JAX, orbax nor the JAX
package, it never drifts to the CPU on its own (the entry points and
the CLIs), `chip_smoke.py` refuses to run without a card, every CLI
answers --help, and the weight bridge round-trips through the JAX
package's checkpoint importer."""

import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from idccrn_vae_tpu.models import torch_import
from idccrn_vae_tpu.models.dccrn import LegacyDccrn as JaxLegacy
from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JaxSupervised
from idccrn_vae_tpu.models.discriminator import Discriminator as JaxDis
from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JaxEncoder
from idccrn_vae_tpu.models.vae import VaeDecoder as JaxDecoder
from idccrn_vae_tpu.models.vae import VaeEncoder as JaxVaeEncoder
from idccrn_vae_torch.eval.enhance import Enhancer
from idccrn_vae_torch.data.stats import corpus_mean_std
from idccrn_vae_torch.eval.dnsmos import ComputeScore, default_model_paths
from idccrn_vae_torch.eval.onnx_exec import InferenceSession
from idccrn_vae_torch.eval.streaming import StreamingEnhancer
from idccrn_vae_torch.losses.nsvae_loss import NsvaeTrueKlLoss
from idccrn_vae_torch.losses.phase2 import EteTrainSeLoss, TwoPhaseLoss
from idccrn_vae_torch.losses.vae_loss import PretrainVaeLoss
from idccrn_vae_torch.models.dccrn import LegacyDccrn, SupervisedDccrn
from idccrn_vae_torch.models.discriminator import Discriminator
from idccrn_vae_torch.models.from_jax import load_jax_variables
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder
from idccrn_vae_torch.train.nsvae import NsvaeTrainer
from idccrn_vae_torch.train.phase2 import Phase2Trainer
from idccrn_vae_torch.train.pretrain import PretrainTrainer
from idccrn_vae_torch.tools import e2e_train
from idccrn_vae_torch.train.supervised import SupervisedTrainer
from torch_port_util import configs, np_vars, subprocess_env

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import idccrn_vae_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "idccrn_vae_tpu",
                                    "orbax"))
for sub in ("cli", "data", "utils", "train", "eval", "models", "ops",
            "losses", "tools"):
    assert any(n.startswith(f"{pkg.__name__}.{sub}.") for n in names), sub
print(len(names), bad)
assert not bad, bad
"""


def _run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, text=True,
                          capture_output=True, timeout=120,
                          env=subprocess_env(**env))


def test_port_imports_neither_jax_nor_the_jax_package():
    r = _run(["-c", _IMPORT_ALL], ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    count, bad = r.stdout.split(maxsplit=1)
    assert int(count) >= 60 and bad.strip() == "[]"


CLIS = ("test_enhance", "test_prevae", "test_supervised", "stream_enhance",
        "train_vae", "train_nsvae", "train_phase2", "train_supervised",
        "cal_mean_std", "dnsmos")


@pytest.mark.parametrize("name", CLIS + ("make_synth_corpus",))
def test_cli_help(name):
    r = _run(["-m", f"idccrn_vae_torch.cli.{name}", "--help"], ROOT)
    assert r.returncode == 0, r.stderr
    flag = ("--cfg_file" if name.startswith("train_") else
            "--mean_out" if name == "cal_mean_std" else
            "--testset_dir" if name == "dnsmos" else "--out")
    assert "usage:" in r.stdout and flag in r.stdout


@pytest.mark.parametrize("name", CLIS)
def test_cli_fails_without_a_card_before_reading_data(name, tmp_path):
    """No card and no --device cpu: the CLI exits non-zero from
    resolve_device, before it opens a checkpoint, reads a wav or an ini,
    or makes its output dir (the inputs here are real, so reading them
    would get further)."""
    from idccrn_vae_tpu.data.audio_io import write_wav

    wavs = tmp_path / "wavs"
    wavs.mkdir()
    write_wav(str(wavs / "noisy_fileid_0.wav"), np.zeros(1600, np.float32),
              16000)
    out = tmp_path / "out"
    ini = wavs / "train.ini"
    ini.write_text("\n".join([
        "[User]", f"saved_root = {out}", f"train_data_dir = {wavs}",
        f"val_data_dir = {wavs}", f"pre_clean_encoder = {tmp_path}",
        f"pre_noise_encoder = {tmp_path}", "model_name = m", ""]))
    train = ["--cfg_file", str(ini), "--first_use_dataset"]
    args = {"test_enhance": ["--nsvae_dir", str(tmp_path), "--noisy_dir",
                             str(wavs), "--clean_dir", str(wavs)],
            "test_prevae": ["--model_dir", str(tmp_path), "--test_dir",
                            str(wavs)],
            "test_supervised": ["--model_dir", str(tmp_path), "--noisy_dir",
                                str(wavs), "--clean_dir", str(wavs)],
            "stream_enhance": ["--model", "supervised", "--model_dir",
                               str(tmp_path), "--in_dir", str(wavs)],
            "train_vae": train, "train_nsvae": train,
            "train_phase2": train + ["--first_phase_folder", str(tmp_path)],
            "train_supervised": train + ["--data_norm"],
            "cal_mean_std": ["--data_dir", str(wavs), "--mean_out",
                             str(out / "mean.txt"), "--std_out",
                             str(out / "std.txt")],
            "dnsmos": ["-t", str(wavs), "-o", str(out / "dnsmos.csv")]}[name]
    if not name.startswith(("train_", "cal_", "dnsmos")):
        args += ["--out_dir", str(out)]
    r = _run(["-m", f"idccrn_vae_torch.cli.{name}", *args], ROOT,
             CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr and "resolve_device" in r.stderr
    assert not out.exists()
    assert sorted(os.listdir(tmp_path)) == ["wavs"]
    assert sorted(os.listdir(wavs)) == ["noisy_fileid_0.wav", "train.ini"]


def test_chip_smoke_fails_without_a_card():
    r = _run(["chip_smoke.py"], ROOT, CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run(["chip_smoke.py"], tmp_path, PYTHONPATH="")
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_entry_points_default_to_cuda_and_do_not_fall_back(tmp_path):
    assert not torch.cuda.is_available()
    _, tc = configs()
    _, noisy = configs(latent_num=2)
    vae_loss = PretrainVaeLoss(np.zeros(0, np.float32), 1.0, num_samples=1)
    enc = NsvaeEncoder(tc, device="cpu").state_dict()
    dec = VaeDecoder(tc, device="cpu").state_dict()
    sup = SupervisedDccrn(tc, device="cpu").state_dict()
    for build in (lambda: NsvaeEncoder(tc), lambda: VaeDecoder(tc),
                  lambda: Enhancer(tc, tc, enc, dec),
                  lambda: VaeEncoder(tc), lambda: SupervisedDccrn(tc),
                  lambda: LegacyDccrn(tc),
                  lambda: StreamingEnhancer(tc, tc, enc, dec),
                  lambda: StreamingEnhancer(tc, tc, sup, None,
                                            model="supervised"),
                  lambda: PretrainTrainer(tc, vae_loss, 1e-3),
                  lambda: NsvaeTrainer(tc, noisy, NsvaeTrueKlLoss(
                      1.0, 0.0, 1.0, 0.0, noisy), 1e-3),
                  lambda: Discriminator(tc),
                  lambda: Phase2Trainer(tc, tc, TwoPhaseLoss(
                      (1.0, 1.0, 0.0), 1.0, 1), 1e-3, adversarial=True),
                  lambda: SupervisedTrainer(tc, EteTrainSeLoss(
                      (1.0, 1.0, 0.0)), 1e-3),
                  lambda: corpus_mean_std([]),
                  lambda: ComputeScore(*default_model_paths()),
                  lambda: InferenceSession(default_model_paths()[1]),
                  lambda: e2e_train.main(["--root", str(tmp_path / "e2e")])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert os.listdir(tmp_path) == []


def _assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_equal(g, w, f"{path}/{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


FAMILIES = {
    "nsvae": ((JaxEncoder, NsvaeEncoder, torch_import.import_nsvae_encoder),
              (JaxDecoder, VaeDecoder, torch_import.import_vae_decoder)),
    "vae_encoder": ((JaxVaeEncoder, VaeEncoder,
                     torch_import.import_vae_encoder),),
    "supervised": ((JaxSupervised, SupervisedDccrn,
                    torch_import.import_supervised_dccrn),),
    "legacy": ((JaxLegacy, LegacyDccrn, torch_import.import_legacy_dccrn),),
    "discriminator": ((JaxDis, Discriminator,
                       torch_import.import_discriminator),),
}


@pytest.mark.parametrize("family,extra", [
    pytest.param("nsvae", {}, id="extra0"),
    pytest.param("nsvae", {"latent": "fc", "latent_num": 2,
                           "channel_mode": "double"}, id="extra1"),
    pytest.param("vae_encoder", {}, id="vae_encoder-sliced"),
    pytest.param("vae_encoder", {"latent": "fc"}, id="vae_encoder-fc"),
    pytest.param("supervised", {"lstm_hidden": 8}, id="supervised"),
    pytest.param("legacy", {"lstm_hidden": 8}, id="legacy"),
    pytest.param("discriminator", {}, id="discriminator"),
])
def test_bridge_round_trips_through_torch_import(family, extra):
    """JAX vars -> load_jax_variables -> port state_dict ->
    torch_import -> the same arrays, exactly. The one exception is the BN
    step counter: the port has no counterpart, and the importer sets it
    to 1 (a trained checkpoint's running stats are live), where `.init`
    gives 0."""
    jc, tc = configs(**extra)
    for jax_model, port_model, importer in FAMILIES[family]:
        variables = np_vars(jax_model(jc).init(jax.random.PRNGKey(3)))
        module = load_jax_variables(port_model(tc, device="cpu"), variables)
        sd = {k: v.numpy() for k, v in module.state_dict().items()}
        back = np_vars(importer(sd, jc))
        for group in back["stats"].values():
            for stage_stats in group:
                assert stage_stats.pop("count") == 1
        for group in variables["stats"].values():
            for stage_stats in group:
                assert stage_stats.pop("count") == 0
        _assert_tree_equal(back, variables)


def test_bridge_rejects_mismatched_variables():
    jc, tc = configs()
    variables = np_vars(JaxDecoder(jc).init(jax.random.PRNGKey(0)))
    with pytest.raises(KeyError, match="missing"):
        load_jax_variables(NsvaeEncoder(tc, device="cpu"), variables)
    _, wide = configs(zdim=8)
    with pytest.raises(ValueError, match="does not fit"):
        load_jax_variables(VaeDecoder(wide, device="cpu"), variables)
