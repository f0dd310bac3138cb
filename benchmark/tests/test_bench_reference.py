"""The plain reference against the port at the tests' width, float32 on
the CPU: each cell's program (the eval forward with given draws, one and
two latents; the chunk stream; one CVAE Adam step's loss, gradients and
update), the weight layouts, and what the harness and the reference
import."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import compare, inputs, programs
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train
from benchmark.tests.conftest import ROOT, tiny_config

torch.set_num_threads(2)
FS = 16000


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("name,use", [("idccrn_vae_z128", "serve"),
                                      ("idccrn_vae_z128", "train"),
                                      ("idccrn_vae_dual_z128", "serve")])
def test_layouts_are_the_port_state_dicts(name, use):
    """The reference's names and shapes are the port modules' state
    dicts, so strict loading takes the benchmark's weights."""
    from idccrn_vae_torch.models.nsvae import NsvaeEncoder
    from idccrn_vae_torch.models.vae import VaeDecoder, VaeEncoder

    config = tiny_config(name)
    enc_cfg, dec_cfg = programs.port_configs(config, use)
    enc = (VaeEncoder if use == "train" else NsvaeEncoder)(enc_cfg,
                                                            device="cpu")
    mods = [enc, VaeDecoder(dec_cfg, device="cpu")]
    for layout, mod in zip(programs.layouts(config, use), mods):
        sd = mod.state_dict()
        assert [(n, tuple(s)) for n, s, _ in layout] == [
            (k, tuple(v.shape)) for k, v in sd.items()]


@pytest.mark.parametrize("name,outtype", [
    ("idccrn_vae_z128", "clean_direct"),
    ("idccrn_vae_dual_z128", "real_imag_mask"),
    ("idccrn_vae_dual_z128", "complex_mask")])
def test_eval_forward(name, outtype):
    config = tiny_config(name)
    config["serve"]["outtype"] = outtype
    geo = ref.Geometry.of(config)
    weights = inputs.make_weights(programs.layouts(config, "serve"), 5, "cpu")
    enh = programs.enhancer(config, weights, 3, "cpu", compute="f32")
    wav = torch.from_numpy(np.stack(
        [inputs.speechlike(np.random.default_rng(i), 4000, FS)
         for i in range(2)]))
    t = 4000 // geo.hop + 1
    latents = config["model"]["latent_num"]
    draws = [inputs.latent_draws((2, 3, t, geo.zdim), 9, k, "cpu")
             for k in range(latents)]
    out = enh.forward(wav, noise=draws[0],
                      noise_n=draws[1] if latents == 2 else None)
    want = ref.enhance(wav, weights, geo, 3, outtype, draws)
    assert out.shape == want.shape
    # float32 round-off; the complex mask S / (S + N) divides by a sum
    # that cancels in places, which scales it up about tenfold
    assert rel(out, want) < (1e-4 if outtype == "complex_mask" else 1e-5)


def test_stream():
    config = tiny_config("idccrn_vae_z128")
    geo = ref.Geometry.of(config)
    weights = inputs.make_weights(programs.layouts(config, "stream"), 3,
                                  "cpu")
    st = programs.streamer(config, weights, 10, "cpu")
    audio = inputs.stream_audio(0.5, 4, FS)
    got = st.stream(audio)
    want = ref.stream_enhance(torch.from_numpy(audio), weights, geo)
    assert got.shape == want.shape
    # the output's first n_fft - hop samples belong to the zeros before
    # the stream, where the window sum nearly vanishes
    lead = geo.n_fft - geo.hop
    assert rel(got[:, lead:], want[:, lead:]) < 1e-5


def test_train_step():
    """One Adam step of the port's trainer and of the reference: the
    loss, each leaf's gradient (the trainer leaves it in .grad; Adam's
    L2 term added) and each leaf's update."""
    config = tiny_config("idccrn_vae_z128")
    geo = ref.Geometry.of(config)
    t = config["train"]
    weights = inputs.make_weights(programs.layouts(config, "train"), 2, "cpu")
    tr = programs.trainer(config, weights, 3, "cpu")
    pool = inputs.segment_pool({"pool_seconds": 1.0, "pool_utterances": 4},
                               1, FS)
    cuts = inputs.segment_cuts(pool, 2, 4000, 1, 0)
    batch = inputs.cut(pool, cuts, 4000)
    draws = inputs.latent_draws((2, 3, 41, geo.zdim), 1, 0, "cpu")
    loss = float(tr.train_step(batch, None, 0, noise=draws)["total"])
    recipe = ref_train.Recipe(3, t["kl_weight"], tuple(t["recon_loss_weight"]),
                              t["lr"], t["weight_decay"])
    want = ref_train.follow(weights[0], weights[1], [torch.from_numpy(batch)],
                            [draws], geo, recipe)
    assert abs(loss - want["loss"][0]) < 1e-5 * abs(want["loss"][0])
    named = {f"enc.{k}": p for k, p in tr.encoder.named_parameters()}
    named.update({f"dec.{k}": p for k, p in tr.decoder.named_parameters()})
    assert sorted(named) == sorted(want["params"])
    raw = {k: float(g.norm()) for k, g in want["grad1_loss"].items()}
    moved = compare.moved_leaves(raw)
    assert len(moved) > len(raw) // 2
    grads, steps = [], []
    for k, p in named.items():
        w0 = weights[k[:3] == "dec"][k[4:]]
        g = p.grad + t["weight_decay"] * w0
        grads.append((float((g - want["grad1"][k]).norm()),
                      float(want["grad1"][k].norm())))
        step = want["params"][k] - w0
        if k in moved:
            steps.append((float((p.detach() - w0 - step).norm()),
                          float(step.norm())))
    # a conv bias before batch norm has a gradient of round-off alone:
    # each leaf is measured against the median leaf at least, and such
    # leaves, which Adam moves by the round-off's sign, are left out of
    # the update's comparison
    assert compare.worst_gap(grads) < 1e-4
    assert compare.worst_gap(steps) < 1e-4


def _modules_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True,
        env=dict(os.environ, PYTHONPATH=ROOT))
    return set(out.stdout.split())


def test_imports():
    """In a fresh interpreter a traced run of every cell at the tests'
    width (the harness, its traffic modules, readers and the port's programs)
    loads no JAX-side module, and the reference loads nothing of the
    port."""
    from benchmark import harness

    harness_mods = _modules_after(
        "import benchmark.calibrate\n"
        "from benchmark.tests.test_bench_harness import bench, small_run\n"
        "for w in bench()['workloads']:\n"
        "    small_run(w['name'], True, compute='f32')")
    assert not harness_mods & set(harness.FORBIDDEN), harness_mods
    assert "idccrn_vae_torch" in harness_mods
    ref_mods = _modules_after(
        "import benchmark.reference.model, benchmark.reference.train")
    assert not ref_mods & (set(harness.FORBIDDEN) | {"idccrn_vae_torch"})
