"""The port's quickstart (`idccrn_vae_torch/examples/quickstart.py`) on
the CPU: all five stages with --device cpu in a temp dir, and its refusal
to run without a card when not given --device cpu."""

import json
import os

import numpy as np
import pytest
import torch

from idccrn_vae_torch.data.audio_io import read_wav
from idccrn_vae_torch.examples import quickstart
from torch_port_util import subprocess_env  # noqa: F401  (thread cap)

RUNS = {"cvae": "complex_CVAE", "nvae": "complex_NVAE",
        "nsvae": "complex_NSVAE", "p2": "phase2_adv"}


def test_quickstart_runs_every_stage_on_the_cpu(tmp_path):
    root = tmp_path / "qs"
    seconds = quickstart.main([str(root), "--device", "cpu"])
    assert list(seconds) == list(quickstart.STAGES)
    for name, model in RUNS.items():
        run = quickstart.latest(str(root), name)
        assert run.endswith(model)
        assert {"meta.json", "best.pt", "state.pt",
                "loss_curves.json"} <= set(os.listdir(run))
        with open(os.path.join(run, "loss_curves.json")) as f:
            curves = json.load(f)
        assert len(curves["train"]) == len(curves["val"]) == 2
    with open(root / "eval" / "per_utterance.json") as f:
        scores = json.load(f)
    assert sorted(scores) == [f"noisy_fileid_{i}.wav" for i in range(4)]
    for row in scores.values():
        assert set(row) >= {"sisdr", "estoi", "pesq"}
        assert all(np.isfinite(v) for v in row.values())
    assert len(os.listdir(root / "eval" / "enhanced")) == 4
    wav, fs = read_wav(str(root / "stream" / "streamed.wav"))
    assert fs == quickstart.FS and wav.shape == (3000,)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_quickstart_without_a_card_raises_before_writing(tmp_path):
    root = tmp_path / "qs"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.main([str(root)])
    assert not root.exists()
