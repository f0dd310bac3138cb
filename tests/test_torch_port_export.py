"""The port's torch.export artifacts (eval/export.py, cli/export_model.py,
cli/run_artifact.py) against the eager port and the JAX package's
artifacts, on the CPU at tiny geometry.

The exported program is a trace of the eager one (`Enhancer.program`):
the same ops on the same inputs, so artifact and eager agree to the
last bit on the CPU, which the tests ask for. The NSVAE artifact takes
its latent draws as inputs. The supervised and streaming artifacts,
held against JAX's artifacts, are in test_torch_port_export_cli.py.
"""

import os

import numpy as np
import pytest
import torch

from idccrn_vae_torch.cli import export_model as t_export
from idccrn_vae_torch.eval import export as texport
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from torch_port_util import (
    TINY_STFT,
    configs,
    wav_batch,
)

HOP = TINY_STFT["hop"]
BUCKETS = (160, 320)  # --seconds 0.01,0.02 at 16 kHz


def _port_dirs(root):
    """Port checkpoint dirs of a phase-1 NSVAE (latent_num 2, so the
    artifact takes the noise latent's draws too) and its CVAE decoder."""
    _, enc = configs(stft=TINY_STFT, latent_num=2)
    _, dec = configs(stft=TINY_STFT)
    gen = lambda k: torch.Generator().manual_seed(k)
    nsvae, cvae = os.path.join(root, "nsvae"), os.path.join(root, "cvae")
    CheckpointManager(nsvae).save_meta({"pre_config": dec,
                                        "noisy_config": enc})
    CheckpointManager(nsvae).save_best({"noisy_enc": NsvaeEncoder(
        enc, device="cpu", generator=gen(1)).state_dict()})
    CheckpointManager(cvae).save_meta({"config": dec, "datanorm": None})
    CheckpointManager(cvae).save_best({"dec": VaeDecoder(
        dec, device="cpu", generator=gen(2)).state_dict()})
    return nsvae, cvae


@pytest.fixture(scope="module")
def nsvae_artifact(tmp_path_factory):
    """An NSVAE artifact of two buckets from export_model: (its dir, the
    live Enhancer of the same checkpoints, load_artifact's call, meta)."""
    from idccrn_vae_torch.cli.common import load_enhancement_checkpoints
    from idccrn_vae_torch.eval.enhance import Enhancer

    root = str(tmp_path_factory.mktemp("nsvae_art"))
    nsvae, cvae = _port_dirs(root)
    out = os.path.join(root, "artifact")
    t_export.main(["--nsvae_dir", nsvae, "--decoder_dir", cvae,
                   "--out_dir", out, "--seconds", "0.01,0.02",
                   "--num_samples", "2", "--device", "cpu"])
    enc_cfg, dec_cfg, enc, dec, _, pad_mode = load_enhancement_checkpoints(
        nsvae, cvae)
    live = Enhancer(enc_cfg, dec_cfg, enc, dec, num_samples=2,
                    pad_mode=pad_mode, device="cpu")
    return (out, live, *texport.load_artifact(out))


def _eager(live):
    serving = texport.serving_fn_nsvae(live)
    return texport.bucketed_call([(n, serving.call) for n in BUCKETS],
                                 serving, "cpu")


def test_nsvae_artifact_matches_eager(nsvae_artifact):
    out_dir, live, call, meta = nsvae_artifact
    assert [b["length"] for b in meta["buckets"]] == list(BUCKETS)
    assert (meta["eps_pairs"], meta["num_samples"], meta["zdim"],
            meta["hop"], meta["device"]) == (2, 2, 4, HOP, "cpu")
    assert sorted(os.listdir(out_dir)) == ["enhance_160.pt2",
                                           "enhance_320.pt2", "meta.json"]
    wav = torch.from_numpy(wav_batch(1, 3, 320))
    t = 320 // HOP + 1
    eps = [torch.randn(3, 2, t, 4, generator=torch.Generator().manual_seed(
        k)) for k in range(4)]
    got = call(wav, *eps)
    assert got.shape == (3, 320) and torch.isfinite(got).all()
    want = live.forward(wav, noise=tuple(eps[:2]), noise_n=tuple(eps[2:]))
    assert torch.equal(got, want)


def test_artifacts_hold_no_profiler_op(nsvae_artifact):
    """The program's spans (`utils/profiling.span`) leave no profiler op
    in an exported graph: the archives' serialized graphs name aten ops
    and no profiler op."""
    import zipfile

    out_dir = nsvae_artifact[0]
    for name in ("enhance_160.pt2", "enhance_320.pt2"):
        with zipfile.ZipFile(os.path.join(out_dir, name)) as z:
            blob = b"".join(z.read(m) for m in z.namelist())
        assert b"aten.conv2d" in blob and b"profiler" not in blob


def test_one_artifact_serves_two_batch_sizes(nsvae_artifact):
    _, live, call, _ = nsvae_artifact
    eager = _eager(live)
    for b in (1, 3):
        wav = wav_batch(2 + b, b, 320)
        got = call(wav, generator=torch.Generator().manual_seed(b))
        want = eager(wav, generator=torch.Generator().manual_seed(b))
        assert got.shape == (b, 320)
        assert torch.equal(got, want)


def test_buckets_pad_and_trim(nsvae_artifact):
    """An input is padded to the smallest covering bucket and the output
    trimmed back; longer input than the largest bucket raises."""
    _, live, call, _ = nsvae_artifact
    eager = _eager(live)
    for n, bucket in ((100, 160), (160, 160), (250, 320)):
        wav = wav_batch(n, 2, n)
        got = call(wav, generator=torch.Generator().manual_seed(n))
        assert got.shape == (2, n)
        # the same draws at the bucket's frame count, on the live program
        padded = np.pad(wav, ((0, 0), (0, bucket - n)))
        want = eager(padded, generator=torch.Generator().manual_seed(n))
        assert torch.equal(got, want[:, :n])
    with pytest.raises(ValueError, match="largest artifact bucket"):
        call(np.zeros((1, 330), np.float32))


@pytest.mark.parametrize("extra,match", [
    (["--streaming", "--seconds", "1,3"], "offline bucket export"),
    (["--streaming", "--outtype", "complex_mask", "--latent_to_use", "2"],
     "clean_direct latent-1"),
    (["--streaming", "--num_samples", "4"], "clean_direct latent-1"),
    (["--seconds", ","], "at least one length"),
    (["--model", "supervised"], "requires --model_dir"),
])
def test_export_model_refusals(tmp_path, extra, match):
    """The JAX CLI's refusals, before any checkpoint is read."""
    argv = ["--nsvae_dir", str(tmp_path / "absent"), "--out_dir",
            str(tmp_path / "o"), "--device", "cpu", *extra]
    with pytest.raises(SystemExit, match=match):
        t_export.main(argv)
    assert not (tmp_path / "o").exists()


def test_export_model_refuses_a_noncausal_stream(tmp_path):
    _, enc = configs(stft=TINY_STFT, causal=False)
    nsvae, cvae = str(tmp_path / "nsvae"), str(tmp_path / "cvae")
    CheckpointManager(nsvae).save_meta({"pre_config": enc,
                                        "noisy_config": enc})
    CheckpointManager(nsvae).save_best(
        {"noisy_enc": NsvaeEncoder(enc, device="cpu").state_dict()})
    CheckpointManager(cvae).save_meta({"config": enc})
    CheckpointManager(cvae).save_best(
        {"dec": VaeDecoder(enc, device="cpu").state_dict()})
    with pytest.raises(SystemExit, match="causal checkpoint"):
        t_export.main(["--nsvae_dir", nsvae, "--decoder_dir", cvae,
                       "--out_dir", str(tmp_path / "o"), "--streaming",
                       "--device", "cpu"])
