"""Validation of one CVAE checkpoint by both packages, at f32 and bf16.

Where does the bf16 trajectory's CVAE validation gap come from
(TRAJECTORY_PARITY_TORCH_BF16.json: train totals within about 2e-3,
val totals 6% apart at epoch 0)? Both packages' `train_vae` CLIs build
their trainer and loaders from the trajectory's arguments for the stage
(`trajectory_parity.stage_argv`), with `fit` replaced by a capture. Both
trainers then take the weights of one JAX checkpoint, the best of a
trajectory run's JAX CVAE, and score the whole val split with their
`eval_step`, at f32 and at bf16, with the same latent draws
(`phase2_eval_parity.fixed_latent_noise`).

Reported, for every val metric (the mean over the val batches):
  * port vs JAX at f32 and at bf16: the same weights, draws and
    batches, so what differs is the two eval paths' arithmetic;
  * bf16 vs f32 within each package: how far bf16 rounding alone moves
    the validation of these weights.
Each gap is |a - b| / max(|b|, 1e-3), the largest over the metrics.

  python -m port_tools.cvae_val_parity --run-root traj_run \\
      --encoder-dim-start 4 --zdim 16 --out CVAE_VAL_PARITY.json

`--run-root` is a `trajectory_parity` working directory that ran the
cvae stage at the reference geometry. It needs JAX and both packages,
and runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from port_tools.phase2_eval_parity import fixed_latent_noise
from port_tools.trajectory_parity import GEOMETRIES, _clis, stage_argv


def _capture(side: str, root: str, dirs: dict, geo: dict) -> tuple:
    """(trainer, val loader) of `side`'s train_vae CLI for the cvae
    stage, its fit never run."""
    import importlib

    pkg = "idccrn_vae_tpu" if side == "jax" else "idccrn_vae_torch"
    cls = importlib.import_module(f"{pkg}.train.pretrain").PretrainTrainer
    got = {}

    def fit(self, train_loader, val_loader, *a, **kw):
        got.update(trainer=self, val=val_loader)
        return [], float("inf")

    os.makedirs(root, exist_ok=True)
    _, argv = stage_argv("cvae", root, dirs, geo, {"cvae": 1}, 1)
    if side == "port":
        argv = argv + ["--device", "cpu"]
    saved, cls.fit = cls.fit, fit
    try:
        _clis(side)["train_vae"](argv)
    finally:
        cls.fit = saved
    return got["trainer"], got["val"]


def _score(trainer, side: str, val, state=None) -> dict:
    """Mean of each val metric over the val batches."""
    import jax

    sums, n = {}, 0
    for batch in val:
        if side == "jax":
            m = trainer.eval_step(state, batch, jax.random.PRNGKey(0), 0)
        else:
            m = trainer.eval_step(batch, None, 0)
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v)
        n += 1
    return {k: v / n for k, v in sums.items()}


def _gap(a: dict, b: dict) -> dict:
    rel = {k: abs(a[k] - b[k]) / max(abs(b[k]), 1e-3) for k in b}
    worst = max(rel, key=rel.get)
    return {"max_rel": rel[worst], "at": worst, "per_metric": rel}


def parity(run_root: str, geo: dict, noise_seed: int = 4) -> dict:
    import jax

    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager

    jax.config.update("jax_platforms", "cpu")
    corpus = os.path.join(run_root, "corpus")
    dirs = {d: os.path.join(corpus, d) for d in os.listdir(corpus)
            if os.path.isdir(os.path.join(corpus, d))}
    models = os.path.join(run_root, "jax", "models_cvae")
    ckpt_dir = os.path.join(models, sorted(os.listdir(models))[-1])
    meta = json.load(open(os.path.join(ckpt_dir, "meta.json")))
    work = os.path.join(run_root, "cvae_val_parity")
    scores, walls = {}, {}
    for compute in ("f32", "bf16"):
        g = dict(geo, compute=compute)
        jtr, jval = _capture("jax", os.path.join(work, "jax"), dirs, g)
        ttr, tval = _capture("port", os.path.join(work, "port"), dirs, g)
        state = jtr.init_state()
        best = CheckpointManager(ckpt_dir).load_best(
            like={"enc": state["enc"], "dec": state["dec"]})
        state = dict(state, enc=best["enc"], dec=best["dec"])
        np_vars = lambda v: jax.tree_util.tree_map(np.asarray, v)
        load_jax_variables(ttr.encoder, np_vars(best["enc"]))
        load_jax_variables(ttr.decoder, np_vars(best["dec"]))
        with fixed_latent_noise(noise_seed, module="vae"):
            for side, tr, val in (("jax", jtr, jval), ("port", ttr, tval)):
                t0 = time.perf_counter()
                scores[f"{side}_{compute}"] = _score(tr, side, val, state)
                walls[f"{side}_{compute}"] = time.perf_counter() - t0
    return {
        "checkpoint": {"dir": os.path.relpath(ckpt_dir, run_root),
                       "epoch": meta.get("epoch"),
                       "best_val": meta.get("best_val")},
        "geometry": geo,
        "scores": scores,
        "gaps": {
            "port_vs_jax_f32": _gap(scores["port_f32"], scores["jax_f32"]),
            "port_vs_jax_bf16": _gap(scores["port_bf16"],
                                     scores["jax_bf16"]),
            "jax_bf16_vs_f32": _gap(scores["jax_bf16"], scores["jax_f32"]),
            "port_bf16_vs_f32": _gap(scores["port_bf16"],
                                     scores["port_f32"]),
        },
        "seconds": walls,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--run-root", required=True)
    p.add_argument("--geometry", choices=sorted(GEOMETRIES),
                   default="reference")
    p.add_argument("--encoder-dim-start", type=int, default=None)
    p.add_argument("--zdim", type=int, default=None)
    p.add_argument("--out", default="CVAE_VAL_PARITY.json")
    args = p.parse_args(argv)
    geo = dict(GEOMETRIES[args.geometry])
    if args.encoder_dim_start:
        geo["encoder_dim_start"] = args.encoder_dim_start
    if args.zdim:
        geo["zdim"] = args.zdim
    report = parity(os.path.abspath(args.run_root), geo)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: (v["max_rel"], v["at"])
                      for k, v in report["gaps"].items()}, indent=1))
    return report


if __name__ == "__main__":
    main()
