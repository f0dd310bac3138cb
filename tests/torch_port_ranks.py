"""What a rank of a data-parallel port test runs (no JAX here: the
ranks are new processes that import this module, and only the port).

A *recipe* describes one trainer step, all of it picklable: the trainer
kind, its constructor arguments, the models' starting state_dicts and BN
counters, the optimizers to replace with SGD (name -> learning rate), the
global batch, the epoch and the seed of the step's generator. The same
recipe runs in the test process without a group (the single-process
step) and on each rank of a group (`steps_on_ranks`), so both take the
same code path up to the group.
"""

from __future__ import annotations

import torch

from idccrn_vae_torch.models.modules import bn_counts, set_bn_counts
from idccrn_vae_torch.parallel import distributed


def build(recipe):
    from idccrn_vae_torch.train.nsvae import NsvaeTrainer
    from idccrn_vae_torch.train.phase2 import Phase2Trainer
    from idccrn_vae_torch.train.pretrain import PretrainTrainer
    from idccrn_vae_torch.train.supervised import SupervisedTrainer

    cls = {"pretrain": PretrainTrainer, "nsvae": NsvaeTrainer,
           "phase2": Phase2Trainer, "supervised": SupervisedTrainer
           }[recipe["kind"]]
    tr = cls(*recipe["args"], device="cpu", **recipe["kwargs"])
    for name, (sd, counts) in recipe["models"].items():
        tr.models[name].load_state_dict(sd)
        set_bn_counts(tr.models[name], counts)
    for name, lr in recipe["sgd"].items():
        params = [p for g in tr.optimizers[name].param_groups
                  for p in g["params"]]
        setattr(tr, name, torch.optim.SGD(params, lr=lr))
    return tr


def model_state(tr):
    """name -> (state_dict, BN counters) of a trainer's models."""
    return {name: ({k: v.detach().clone() for k, v in
                    m.state_dict().items()}, bn_counts(m).tolist())
            for name, m in tr.models.items()}


def run_step(recipe):
    """One train step of the recipe's trainer -> (metrics, model state)."""
    tr = build(recipe)
    gen = torch.Generator().manual_seed(recipe["seed"])
    metrics = tr.train_step(recipe["batch"], gen, recipe["epoch"])
    return ({k: float(v) for k, v in metrics.items()}, model_state(tr))


def steps_on_ranks(recipes):
    """Each recipe's step on this rank; rank 0 returns every rank's
    results (a list indexed by rank)."""
    out = [run_step(r) for r in recipes]
    every = [None] * distributed.world()
    torch.distributed.all_gather_object(every, out)
    return every


def patch_noise(module: str, seed: int, real_rows=None) -> None:
    """Route the draws of the port encoder in `idccrn_vae_torch.models.
    <module>` through fixed numpy draws of the global batch, this rank's
    rows kept: for each global shape (real_rows, S, T, H) one (eps_r,
    eps_i) pair from `numpy.random.default_rng(seed)`, as
    `torch_port_util.FixedNoise(seed)` hands the JAX side; pad rows
    past `real_rows` (default: the whole global batch) draw zeros."""
    import importlib

    import numpy as np

    from idccrn_vae_torch.models import reparam

    draws = {}

    def fixed(g, num_samples, guard="eps", noise=None, generator=None):
        b, t, h = g.mu_r.shape
        n, r = distributed.world(), distributed.rank()
        real = b * n if real_rows is None else real_rows
        key = (real, num_samples, t, h)
        if key not in draws:
            rng = np.random.default_rng(seed)
            draws[key] = [rng.standard_normal(key).astype(np.float32)
                          for _ in range(2)]
        pad = np.zeros((b * n - real,) + key[1:], np.float32)
        eps = tuple(torch.from_numpy(np.concatenate([e, pad])[r * b:
                                                              (r + 1) * b])
                    for e in draws[key])
        return reparam.reparameterize(g, num_samples, guard=guard, noise=eps)

    mod = importlib.import_module(f"idccrn_vae_torch.models.{module}")
    mod.reparameterize = fixed


def cli_main(cli: str, argv, noise=None):
    """`idccrn_vae_torch.cli.<cli>.main(argv)` on this rank, after
    `patch_noise(*noise)` when given."""
    import importlib

    if noise is not None:
        patch_noise(*noise)
    return importlib.import_module(f"idccrn_vae_torch.cli.{cli}").main(argv)
