"""Convert a JAX package checkpoint dir into a checkpoint dir of the port.

The port's counterpart of `idccrn_vae_tpu/cli/convert_torch.py`: a run
trained with `idccrn_vae_tpu` (a `CheckpointManager` dir: meta.json and
the orbax trees best/ and state/) becomes a dir that the port's CLIs
read (meta.json, best.pt, state.pt), so it evaluates with
`idccrn_vae_torch` and resumes there with --reload.

  python -m port_tools.convert_jax_checkpoint --jax_dir runs/cvae \
      --out_dir runs_torch/cvae

It needs JAX, orbax and both packages in one process, so it lives
outside `idccrn_vae_torch` (which imports neither) and runs on the CPU.

- meta.json is copied as it is: the port writes the JAX package's schema
  (configs, datanorm, epoch, best_val, patience, the schedulers' state),
  and loss_curves.json is copied beside it.
- best/: each model's variables become the port's state_dict
  (`from_jax.jax_to_state_dict`); the supervised family's bare variable
  tree becomes its bare state_dict under the `std_DCCRN.` prefix.
- state/: the port trainer of the run's kind is built on the CPU from
  meta.json; its models load the JAX variables, BN step counters
  included (`from_jax.load_jax_variables`), and each optimizer gets the
  JAX Adam moments as `torch.optim.Adam` state (`exp_avg`, `exp_avg_sq`,
  `step`) for every parameter it holds, with the JAX run's learning
  rate. The result is the trainer's own `state_dict()`, the layout its
  resume reads. The weight decay is the trainers' default, 1e-3, as in
  every JAX trainer CLI.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Dict

import numpy as np
import torch

OPTIMIZER_MODEL = {"opt_en": "enc", "opt_de": "dec", "opt_dis": "dis"}


def run_kind(meta: dict) -> str:
    """'nsvae', 'phase2', 'pretrain' or 'supervised', from meta.json's
    model configs and scheduler entries."""
    if "noisy_config" in meta:
        return "nsvae"
    if "enc_config" in meta:
        return "phase2"
    if "sched_en" in meta:
        return "pretrain"
    if "config" in meta:
        return "supervised"
    raise ValueError("meta.json names no model configuration")


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree if tree is None else np.asarray(tree)


def _is_variables(tree) -> bool:
    return isinstance(tree, dict) and "params" in tree


def convert_best(best: dict) -> dict:
    """JAX best tree -> what the port's best.pt holds."""
    from idccrn_vae_torch.models.dccrn import SupervisedDccrn
    from idccrn_vae_torch.models.from_jax import jax_to_port_tensors

    if _is_variables(best):
        return jax_to_port_tensors(best, SupervisedDccrn.prefix)
    return {name: jax_to_port_tensors(v) for name, v in best.items()}


def _trainer(meta: dict, kind: str):
    """The port trainer of a run of `kind`, on the CPU, from meta.json
    (the weights are replaced by the converted ones)."""
    from idccrn_vae_torch.cli.common import config_from_meta
    from idccrn_vae_torch.train.checkpoint import datanorm_from_meta

    lr = 1e-3  # replaced by each optimizer's converted learning rate
    if kind == "pretrain":
        from idccrn_vae_torch.train.pretrain import PretrainTrainer

        return PretrainTrainer(config_from_meta(meta), None, lr,
                               datanorm=datanorm_from_meta(meta),
                               device="cpu")
    if kind == "nsvae":
        from idccrn_vae_torch.train.nsvae import NsvaeTrainer

        return NsvaeTrainer(config_from_meta(meta, "pre_config"),
                            config_from_meta(meta, "noisy_config"), None, lr,
                            trainable=meta.get("trainable"), device="cpu")
    if kind == "phase2":
        from idccrn_vae_torch.train.phase2 import Phase2Trainer

        return Phase2Trainer(config_from_meta(meta, "enc_config"),
                             config_from_meta(meta, "dec_config"), None, lr,
                             adversarial=bool(meta.get("adversarial")),
                             decode_update=meta.get("decode_update",
                                                    "all_decode"),
                             device="cpu")
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    return SupervisedTrainer(config_from_meta(meta), None, lr,
                             datanorm=datanorm_from_meta(meta), device="cpu")


def _adam_state(opt_tree) -> dict:
    """The {count, mu, nu} node of an optax inject_hyperparams(chain(
    add_decayed_weights, adam)) state as orbax restores it."""
    if isinstance(opt_tree, dict):
        if {"count", "mu", "nu"} <= set(opt_tree):
            return opt_tree
        nodes = opt_tree.values()
    elif isinstance(opt_tree, (list, tuple)):
        nodes = opt_tree
    else:
        nodes = ()
    for node in nodes:
        found = _adam_state(node)
        if found is not None:
            return found
    return None


def _moments(tree, jax_models: dict, opt_name: str,
             trainer) -> Dict[int, np.ndarray]:
    """One Adam moment tree (params-shaped, per model or for one model)
    -> {id(port parameter): array in its shape}."""
    from idccrn_vae_torch.models.from_jax import jax_to_state_dict

    if opt_name in OPTIMIZER_MODEL:
        per_model = {OPTIMIZER_MODEL[opt_name]: tree}
    elif set(tree) <= set(jax_models):
        per_model = tree
    else:  # the supervised trainer's single model
        per_model = {"model": tree}
    out = {}
    for name, params in per_model.items():
        module = trainer.models[name]
        prefix = getattr(module, "prefix", "")
        arrays = jax_to_state_dict(
            {"params": params, "stats": jax_models[name]["stats"]}, prefix)
        for pname, p in module.named_parameters():
            out[id(p)] = arrays[pname].reshape(p.shape)
    return out


def convert_state(state: dict, meta: dict) -> dict:
    """JAX state tree -> the port trainer's state_dict (state.pt)."""
    from idccrn_vae_torch.models.from_jax import load_jax_variables
    from idccrn_vae_torch.train.optim import set_learning_rate

    kind = run_kind(meta)
    trainer = _trainer(meta, kind)
    jax_models = (state["models"] if "models" in state
                  else {k: state[k] for k in ("enc", "dec", "model")
                        if k in state})
    for name, module in trainer.models.items():
        load_jax_variables(module, jax_models[name])
    for opt_name, opt in trainer.optimizers.items():
        tree = state[opt_name]
        adam = _adam_state(tree)
        if adam is None:
            raise ValueError(f"{opt_name}: no Adam moments in the JAX state")
        set_learning_rate(opt, float(tree["hyperparams"]["learning_rate"]))
        mu = _moments(adam["mu"], jax_models, opt_name, trainer)
        nu = _moments(adam["nu"], jax_models, opt_name, trainer)
        step = torch.tensor(float(adam["count"]))
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = {"step": step.clone(),
                                "exp_avg": torch.from_numpy(
                                    np.array(mu[id(p)], np.float32)),
                                "exp_avg_sq": torch.from_numpy(
                                    np.array(nu[id(p)], np.float32))}
    return trainer.state_dict()


def convert(jax_dir: str, out_dir: str) -> str:
    """Write the port's checkpoint dir of the JAX checkpoint dir
    `jax_dir` to `out_dir`; returns out_dir."""
    from idccrn_vae_torch.train.checkpoint import CheckpointManager as Out
    from idccrn_vae_tpu.train.checkpoint import CheckpointManager as In

    src, dst = In(jax_dir), Out(out_dir)
    meta = src.load_meta()
    dst.save_meta(meta)
    curves = os.path.join(jax_dir, "loss_curves.json")
    if os.path.exists(curves):
        shutil.copyfile(curves, os.path.join(out_dir, "loss_curves.json"))
    if src.has_best():
        dst.save_best(convert_best(_np(src.load_best())))
    if src.has_state():
        dst.save_state(convert_state(_np(src.load_state()), meta))
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--jax_dir", required=True,
                   help="a JAX CheckpointManager dir (meta.json, best/, "
                        "state/)")
    p.add_argument("--out_dir", required=True,
                   help="the port checkpoint dir to write")
    args = p.parse_args(argv)
    convert(args.jax_dir, args.out_dir)
    print(json.dumps({"out_dir": args.out_dir,
                      "files": sorted(os.listdir(args.out_dir))}))


if __name__ == "__main__":
    main()
