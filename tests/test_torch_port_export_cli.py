"""The port's export CLIs and streaming artifact against the JAX
package's, on the CPU at tiny geometry.

The supervised program and the streaming chunk step (z = mu) are
deterministic, so the port's artifacts are held against JAX's artifacts
of the same weights: run_artifact's wavs (windows and overlap-add
included) to one PCM16 step, the streaming step's output and carried
state to the f32 tolerance of tests/torch_port_util.py (atol/rtol 1e-4),
and the streaming artifact against the port's eager StreamingEnhancer
exactly (it is a trace of `StreamingEnhancer._chunk_step`).
"""

import json
import os

import jax
import numpy as np
import torch

from idccrn_vae_torch.cli import export_model as t_export
from idccrn_vae_torch.cli import run_artifact as t_run
from idccrn_vae_torch.eval import export as texport
from idccrn_vae_torch.models.nsvae import NsvaeEncoder
from idccrn_vae_torch.models.vae import VaeDecoder
from torch_port_util import (
    F32_TOL,
    TINY_STFT,
    assert_wavs_within_lsb,
    configs,
    datanorm_stats,
    np_vars,
    wav_batch,
    write_test_set,
)


def _supervised_dirs(root):
    """A JAX supervised checkpoint dir and the port's, converted from it."""
    from idccrn_vae_tpu.models.dccrn import SupervisedDccrn as JSupervised
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager as JCkpt
    from idccrn_vae_tpu.train.checkpoint import datanorm_to_meta
    from port_tools.convert_jax_checkpoint import convert

    jc, _ = configs(stft=TINY_STFT, causal=True, recon_type="mask",
                    lstm_hidden=8)
    dn = datanorm_stats(4, TINY_STFT["n_fft"] // 2 + 1)
    jdir = os.path.join(root, "sup_jax")
    ckpt = JCkpt(jdir)
    ckpt.save_meta({"config": jc, "datanorm": datanorm_to_meta(dn)})
    ckpt.save_best(np_vars(JSupervised(jc, dn).init(jax.random.PRNGKey(3))))
    return jdir, convert(jdir, os.path.join(root, "sup_port"))


def test_run_artifact_matches_jax_run_artifact(tmp_path, capsys):
    """export_model + run_artifact on a supervised checkpoint, each
    package on its own dir of the same weights: the wavs agree to one
    PCM16 step, windows and overlap-add included."""
    from idccrn_vae_tpu.cli.export_model import main as j_export
    from idccrn_vae_tpu.cli.run_artifact import main as j_run

    jdir, tdir = _supervised_dirs(str(tmp_path))
    noisy, _, _ = write_test_set(tmp_path / "data", (1000, 320, 520), seed=2)
    in_dir = os.path.dirname(noisy[0])
    arts = [str(tmp_path / "art_j"), str(tmp_path / "art_t")]
    outs = [str(tmp_path / "out_j"), str(tmp_path / "out_t")]
    flags = ["--model", "supervised", "--seconds", "0.02"]
    j_export([*flags, "--model_dir", jdir, "--out_dir", arts[0]])
    t_export.main([*flags, "--model_dir", tdir, "--out_dir", arts[1],
                   "--device", "cpu"])
    j_run(["--artifact_dir", arts[0], "--in_dir", in_dir, "--out_dir",
           outs[0], "--batch_size", "3"])
    report = t_run.main(["--artifact_dir", arts[1], "--in_dir", in_dir,
                         "--out_dir", outs[1], "--batch_size", "3",
                         "--device", "cpu"])
    # windows of 320 overlapping by 32: 1000 samples at 0, 288, 576 and
    # 864; 320 in one; 520 at 0 and 288
    assert report["files"] == 3 and report["windows"] == 7
    assert report["device"] == report["exported_on"] == "cpu"
    assert_wavs_within_lsb(outs[1], outs[0],
                           sorted(os.path.basename(p) for p in noisy))


def test_streaming_artifact_matches_streamer_and_jax(tmp_path):
    """The streaming artifact, chunk by chunk, against the port's
    StreamingEnhancer (exactly) and against JAX's exported streaming
    step of the same weights (F32_TOL), output and carried state."""
    from idccrn_vae_torch.eval.streaming import StreamingEnhancer
    from idccrn_vae_tpu.eval import export as jexport
    from idccrn_vae_tpu.eval.streaming import StreamingEnhancer as JStreamer
    from idccrn_vae_tpu.models.nsvae import NsvaeEncoder as JEncoder
    from idccrn_vae_tpu.models.vae import VaeDecoder as JDecoder
    from idccrn_vae_torch.models.from_jax import load_jax_variables

    jc, tc = configs()  # the reference STFT: the chunk step's frame math
    je = np_vars(JEncoder(jc).init(jax.random.PRNGKey(5)))
    jd = np_vars(JDecoder(jc).init(jax.random.PRNGKey(6)))
    te = load_jax_variables(NsvaeEncoder(tc, device="cpu"), je).state_dict()
    td = load_jax_variables(VaeDecoder(tc, device="cpu"), jd).state_dict()
    streamer = StreamingEnhancer(tc, tc, te, td, chunk_frames=4,
                                 device="cpu")
    exported, spec = texport.export_streaming(streamer, batch=2)
    # the chunk step's spans (utils/profiling.span) leave no profiler op
    assert not [n for n in exported.graph.nodes if n.op == "call_function"
                and "profiler" in str(n.target)]
    texport.save_streaming_artifact(str(tmp_path), exported, spec, "cpu",
                                    {"chunk_samples":
                                     streamer.chunk_samples})
    step, init_state, meta = texport.load_streaming_artifact(str(tmp_path))
    assert meta["state_spec"] == spec and meta["device"] == "cpu"
    with open(tmp_path / "stream_meta.json") as f:
        assert json.load(f)["artifact"] == "stream_step.pt2"

    j_streamer = JStreamer(jc, jc, je, jd, chunk_frames=4)
    j_exported, j_spec = jexport.export_streaming(j_streamer, batch=2,
                                                  platforms=("cpu",))
    assert len(j_spec) == len(spec)
    m = streamer.chunk_samples
    wav = wav_batch(7, 2, 6 * m)
    state, ref_state = init_state(), streamer.init_state(2)
    j_state = [np.zeros(s, d) for s, d in j_spec]
    for k in range(6):
        chunk = wav[:, k * m:(k + 1) * m]
        out, state = step(state, chunk)
        ref, ref_state = streamer.process_chunk(ref_state, chunk)
        j_out, j_state = j_exported.call(j_state, chunk)
        assert torch.equal(out, ref), k
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   err_msg=f"chunk {k}", **F32_TOL)
    for got, want in zip(state, j_state):
        np.testing.assert_allclose(got.numpy().reshape(np.shape(want)),
                                   np.asarray(want), **F32_TOL)
