"""`port_tools/trajectory_parity.py` driven through its command line at
its smallest size: the tiny geometry (the tests' STFT, 100-frame
segments, 0.5 s utterances), two training and two validation utterances,
2 epochs, the supervised DCCRN stage and its evaluation through both
packages' CLIs. (The whole recipe at this size compiles six JAX trainers
and seven evaluation programs, minutes on a CPU; the stages share the
harness code this drives, and tests/test_torch_port_trajectory*.py hold
the other trainers' fits.)"""

import json

import torch_port_util  # noqa: F401  (caps torch's threads per worker)
from port_tools import trajectory_parity as tp


def test_harness_cli_at_its_smallest_size(tmp_path):
    out = tmp_path / "TRAJECTORY_PARITY_TORCH.json"
    tp.main(["--geometry", "tiny", "--n-train", "2", "--n-val", "2",
             "--epochs-scale", "0.07", "--stages", "sup", "--evals",
             "evalsup", "--root", str(tmp_path / "run"), "--out", str(out)])
    with open(out) as f:
        report = json.load(f)
    assert report["verdict"] == "MATCH" and report["first_failure"] is None
    geo = report["geometry"]
    assert (geo["nfft"], geo["hopfrac"], geo["winlen"]) == (32, 8, 16)
    assert geo["epochs"]["sup"] == 2
    assert "train utterances 96 -> 2" in report["cuts"]
    assert "nfft 512 -> 32" in report["cuts"]
    sup = report["stages"]["sup"]
    for side in ("jax", "port"):
        assert sup[side]["epochs_run"] == 2
        assert sup[side]["improved_epochs"] == sup["jax"]["improved_epochs"]
    assert sup["compare"]["ok"] and len(sup["compare"]["per_epoch"]) == 2
    ev = report["evals"]["evalsup"]
    assert ev["utterances"] == 2
    # no phase-2 leg ran, so no noisy baseline and no deltas
    assert ev["estoi_delta_ok"] is None and "delta_diff" not in ev["estoi"]
    for m in tp.METRICS:
        assert ev[m]["max_abs_diff"] <= 1e-2 * max(1.0, abs(ev[m]["mean_jax"]))
