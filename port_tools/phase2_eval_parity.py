"""Both packages' `test_enhance --phase 2` on one phase-2 checkpoint, at the
reference width and the E2E's flags, compared utterance by utterance.

The weights: a seeded JAX NSVAE noisy encoder (latent_num 2, as the
E2E's NSVAE stage trains it) and a phase-2 decoder (the E2E's
train_phase2 flags: runtime skips, mask reconstruction, latent_num 1),
at `DccrnConfig()`'s width (channels 1-32-64-128-128-256-256, zdim
128, causal). Every complex BN gets running means, variances and step
counts drawn from the seed, as a trained run has. They are saved as a
JAX checkpoint dir, and the port's dir is made from it by
`port_tools/convert_jax_checkpoint.py`.

The data: `make_corpus`'s validation split (the E2E's corpus recipe,
6.5 s mixes), each file cut to `--seconds`. Both CLIs run with the
E2E's flags (`--phase 2 --num_samples 10 --batch_size 12 --compute
bf16 --write_wavs`), the port with `--device cpu`, and with the same
latent noise: each batch shape gets one fixed draw on both sides (the
JAX CLI draws once per traced batch shape).

  python -m port_tools.phase2_eval_parity --work_dir /tmp/p2 \
      --utterances 104 --seconds 6.5 --out p2_parity.json

prints, and writes to --out, the largest per-utterance differences of
SI-SDR, ESTOI and PESQ, the largest wav difference in PCM16 steps and
relative L2, and both sides' means. It needs JAX, orbax and both
packages, so it runs on the CPU of a machine that has them all.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time

import numpy as np

FS = 16000
E2E_FLAGS = ["--phase", "2", "--num_samples", "10", "--batch_size", "12",
             "--compute", "bf16", "--write_wavs"]
METRICS = ("sisdr", "estoi", "pesq")


def configs():
    """(encoder config, decoder config) of the JAX package: the E2E's
    NSVAE noisy encoder and its phase-2 decoder at the reference width."""
    from idccrn_vae_tpu.models.config import DccrnConfig

    enc = DccrnConfig(causal=True, zdim=128, num_samples=1, latent_num=2,
                      compute="bf16")
    dec = dataclasses.replace(enc, latent_num=1, skip_mode="runtime",
                              recon_type="mask")
    return enc, dec


def _trained_stats(variables, rng: np.random.Generator):
    """Replace each complex BN's running statistics and counter with
    seeded values of a trained run's kind: means ~ 0.1 N(0, 1),
    variances in [0.5, 2], the covariance inside its positive-definite
    range, counts in [1, 5000]."""
    stats = variables["stats"]
    for group in ("encoder", "decoder"):
        for s in stats.get(group, []):
            c = np.asarray(s["Vrr"]).shape
            vrr = rng.uniform(0.5, 2.0, c)
            vii = rng.uniform(0.5, 2.0, c)
            s.update(mean_r=0.1 * rng.standard_normal(c),
                     mean_i=0.1 * rng.standard_normal(c),
                     Vrr=vrr, Vii=vii,
                     Vri=0.5 * np.sqrt(vrr * vii) * rng.uniform(-1, 1, c),
                     count=np.asarray(rng.integers(1, 5000), np.int32))
            for k in ("mean_r", "mean_i", "Vrr", "Vii", "Vri"):
                s[k] = np.asarray(s[k], np.float32)
    return variables


def write_checkpoints(root: str, seed: int = 0):
    """The JAX phase-2 dir and the port dir converted from it:
    (jax_dir, port_dir)."""
    import jax

    from idccrn_vae_tpu.models.nsvae import NsvaeEncoder
    from idccrn_vae_tpu.models.vae import VaeDecoder
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager
    from port_tools.convert_jax_checkpoint import convert

    enc_cfg, dec_cfg = configs()
    rng = np.random.default_rng(seed)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    as_np = lambda v: jax.tree.map(np.asarray, v)
    best = {"encoder": _trained_stats(as_np(NsvaeEncoder(enc_cfg).init(k1)),
                                      rng),
            "decoder": _trained_stats(as_np(VaeDecoder(dec_cfg).init(k2)),
                                      rng)}
    jax_dir = os.path.join(root, "jax_p2")
    ckpt = CheckpointManager(jax_dir)
    ckpt.save_meta({"model_name": "phase2_classical", "enc_config": enc_cfg,
                    "dec_config": dec_cfg, "adversarial": False,
                    "decode_update": "all_decode"})
    ckpt.save_best(best)
    return jax_dir, convert(jax_dir, os.path.join(root, "port_p2"))


def make_eval_corpus(root: str, utterances: int, seconds: float):
    """The E2E corpus recipe's validation split (6.5 s mixes, SNR buckets
    round-robin), each file cut to `seconds`: (noisy dir, clean dir)."""
    from idccrn_vae_torch.data.audio_io import read_wav, write_wav
    from idccrn_vae_torch.data.synth import make_corpus

    dirs, _ = make_corpus(root, 0, utterances, utt_seconds=6.5, fs=FS)
    n = int(seconds * FS)
    for kind in ("noisy", "clean"):
        d = dirs[f"{kind}_val"]
        for name in os.listdir(d):
            path = os.path.join(d, name)
            write_wav(path, read_wav(path)[0][:n], FS)
    return dirs["noisy_val"], dirs["clean_val"]


class FixedDraws:
    """One draw per shape (b, s, t, h), the same on every call."""

    def __init__(self, seed: int):
        self.seed = seed
        self.draws = {}

    def __call__(self, b, s, t, h):
        key = (b, s, t, h)
        if key not in self.draws:
            rng = np.random.default_rng(self.seed)
            self.draws[key] = tuple(
                rng.standard_normal((b, s, t, h)).astype(np.float32)
                for _ in range(2))
        return self.draws[key]


@contextlib.contextmanager
def fixed_latent_noise(seed: int, module: str = "nsvae"):
    """Both packages' encoders of `module` ('nsvae' or 'vae') draw their
    latent noise from one FixedDraws inside the block."""
    import importlib

    import jax.numpy as jnp
    import torch

    tnsvae = importlib.import_module(f"idccrn_vae_torch.models.{module}")
    jnsvae = importlib.import_module(f"idccrn_vae_tpu.models.{module}")

    draws = FixedDraws(seed)
    j_orig, t_orig = jnsvae.reparameterize, tnsvae.reparameterize

    def j_fixed(rng, g, num_samples, guard="eps", noise=None):
        er, ei = draws(*g.mu_r.shape[:1], num_samples, *g.mu_r.shape[1:])
        return j_orig(rng, g, num_samples, guard=guard,
                      noise=(jnp.asarray(er), jnp.asarray(ei)))

    def t_fixed(g, num_samples, guard="eps", noise=None, generator=None):
        er, ei = draws(*g.mu_r.shape[:1], num_samples, *g.mu_r.shape[1:])
        return t_orig(g, num_samples, guard=guard,
                      noise=(torch.from_numpy(er).to(g.mu_r.device),
                             torch.from_numpy(ei).to(g.mu_r.device)))

    jnsvae.reparameterize, tnsvae.reparameterize = j_fixed, t_fixed
    try:
        yield
    finally:
        jnsvae.reparameterize, tnsvae.reparameterize = j_orig, t_orig


def run_both(jax_dir: str, port_dir: str, noisy: str, clean: str,
             out_root: str, noise_seed: int = 4):
    """Run both CLIs; returns (JAX out dir, port out dir, seconds of
    each)."""
    from idccrn_vae_torch.cli.test_enhance import main as t_main
    from idccrn_vae_tpu.cli.test_enhance import main as j_main

    common = ["--noisy_dir", noisy, "--clean_dir", clean, *E2E_FLAGS]
    outs = [os.path.join(out_root, "out_jax"),
            os.path.join(out_root, "out_port")]
    walls = []
    with fixed_latent_noise(noise_seed):
        t0 = time.perf_counter()
        j_main(["--nsvae_dir", jax_dir, "--out_dir", outs[0], *common])
        walls.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        t_main(["--nsvae_dir", port_dir, "--out_dir", outs[1],
                "--device", "cpu", *common])
        walls.append(time.perf_counter() - t0)
    return outs[0], outs[1], walls


def compare(jax_out: str, port_out: str) -> dict:
    """Largest per-utterance metric differences, the wavs' largest
    difference in PCM16 steps and relative L2, and both sides' means."""
    from idccrn_vae_torch.data.audio_io import read_wav

    load = lambda d: json.load(open(os.path.join(d, "per_utterance.json")))
    jp, tp = load(jax_out), load(port_out)
    if sorted(jp) != sorted(tp):
        raise ValueError("the two runs scored different utterances")
    rep = {"utterances": len(jp)}
    for m in METRICS:
        j = np.asarray([jp[u][m] for u in sorted(jp)])
        t = np.asarray([tp[u][m] for u in sorted(jp)])
        rep[m] = {"max_abs_diff": float(np.abs(t - j).max()),
                  "mean_jax": float(j.mean()), "mean_port": float(t.mean())}
    lsb, rel = 0.0, 0.0
    for name in sorted(os.listdir(os.path.join(jax_out, "enhanced"))):
        j = read_wav(os.path.join(jax_out, "enhanced", name))[0]
        t = read_wav(os.path.join(port_out, "enhanced", name))[0]
        if j.shape != t.shape:
            raise ValueError(f"{name}: {t.shape} against {j.shape}")
        lsb = max(lsb, float(np.abs(t - j).max()) * 32768)
        rel = max(rel, float(np.linalg.norm(t - j)
                             / max(np.linalg.norm(j), 1e-12)))
    rep["wav_max_diff_pcm16"] = lsb
    rep["wav_max_rel_l2"] = rel
    return rep


def parity(work_dir: str, utterances: int, seconds: float,
           seed: int = 0) -> dict:
    os.makedirs(work_dir, exist_ok=True)
    jax_dir, port_dir = write_checkpoints(os.path.join(work_dir, "ckpt"),
                                          seed)
    noisy, clean = make_eval_corpus(os.path.join(work_dir, "corpus"),
                                    utterances, seconds)
    jax_out, port_out, walls = run_both(jax_dir, port_dir, noisy, clean,
                                        work_dir)
    rep = compare(jax_out, port_out)
    rep.update(seconds_per_file=seconds, flags=" ".join(E2E_FLAGS),
               jax_cli_s=walls[0], port_cli_s=walls[1])
    return rep


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--work_dir", required=True)
    p.add_argument("--utterances", type=int, default=104)
    p.add_argument("--seconds", type=float, default=6.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="also write the report here")
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    rep = parity(args.work_dir, args.utterances, args.seconds, args.seed)
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)


if __name__ == "__main__":
    main()
