"""Shared epoch loop of the trainers.

Mirrors `idccrn_vae_tpu/train/loop.py` (the reference's train.py:
254-434 skeleton): per-epoch train/val metric accumulation, the plateau
scheduler on the val loss, the best checkpoint and early stop on
patience.

In a data-parallel group (`parallel/`) every rank runs this loop on the
same global batches and holds its rows of each (`Trainer.
batch_to_device`); the epoch metrics are averaged over the ranks, so
every rank takes the same scheduler, best-epoch and early-stop decision,
and only rank 0 writes checkpoints, meta.json and loss_curves.json.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, Iterable

import torch

from idccrn_vae_torch.models.modules import bn_counts, set_bn_counts
from idccrn_vae_torch.parallel import distributed
from idccrn_vae_torch.parallel.mesh import (
    average_gradients,
    replicate,
    shard_batch,
)
from idccrn_vae_torch.train.checkpoint import CheckpointManager
from idccrn_vae_torch.utils.logger import get_logger


class MetricAccumulator:
    """Sample-weighted averages with PER-KEY counts: a key emitted only
    on some batches averages over the samples that reported it, not the
    whole epoch."""

    def __init__(self):
        self.sums: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.count = 0

    def add(self, metrics: Dict, batch_size: int):
        for k, v in metrics.items():
            self.sums[k] = self.sums.get(k, 0.0) + float(v) * batch_size
            self.counts[k] = self.counts.get(k, 0) + batch_size
        self.count += batch_size

    def averages(self, device=None) -> Dict[str, float]:
        """In a data-parallel group, the averages over every rank's
        sums (each rank's metric is the mean over its equal shard, so
        this is the single-process average)."""
        keys = sorted(self.sums)
        totals = distributed.all_reduce_floats(
            [self.sums[k] for k in keys] + [self.counts[k] for k in keys],
            device)
        n = len(keys)
        return {k: totals[i] / totals[n + i] for i, k in enumerate(keys)}


def epoch_generator(seed: int, epoch: int, train: bool,
                    device: torch.device) -> torch.Generator:
    """The generator of one epoch's train (or val) steps, on `device`,
    seeded from (seed, epoch, train/val) alone: a run resumed at epoch k
    draws what an uninterrupted one draws from epoch k on (the JAX
    package folds the epoch into its key for the same guarantee)."""
    return torch.Generator(device).manual_seed(
        (seed * 1_000_003 + 2 * epoch + (0 if train else 1)) % 2**63)


def _batch_size(batch) -> int:
    return (batch[0] if isinstance(batch, tuple) else batch).shape[0]


def run_training(*, epochs: int, start_epoch: int, train_loader: Iterable,
                 val_loader: Iterable,
                 train_step: Callable,   # (batch, generator, epoch) -> metrics
                 eval_step: Callable,    # (batch, generator, epoch) -> metrics
                 seed: int, device: torch.device,
                 schedulers_step: Callable,  # (val_total) -> None
                 on_best: Callable,          # (epoch) -> None
                 on_checkpoint: Callable,    # (epoch, best, patience, curves)
                 logger, early_stop_patience: int,
                 best_val: float = float("inf"), patience: int = 0,
                 loss_key: str = "total", save_frequency: int = 10):
    """Returns (curves dict, best_val). The trainer's modules and
    optimizers hold the state; the steps update them in place."""
    curves: Dict[str, list] = {"train": [], "val": []}
    for epoch in range(start_epoch, epochs):
        t0 = time.time()
        # pin the data order to the global epoch (resume fidelity)
        for ldr in (train_loader, val_loader):
            if hasattr(ldr, "set_epoch"):
                ldr.set_epoch(epoch)
        acc = MetricAccumulator()
        gen = epoch_generator(seed, epoch, True, device)
        for batch in train_loader:
            acc.add(train_step(batch, gen, epoch), _batch_size(batch))
        train_avg = acc.averages(device)

        vacc = MetricAccumulator()
        gen = epoch_generator(seed, epoch, False, device)
        for batch in val_loader:
            vacc.add(eval_step(batch, gen, epoch), _batch_size(batch))
        val_avg = vacc.averages(device)
        val_total = val_avg.get(loss_key, float("nan"))

        curves["train"].append(train_avg)
        curves["val"].append(val_avg)
        schedulers_step(val_total)

        improved = val_total < best_val
        if improved:
            best_val = val_total
            patience = 0
            on_best(epoch)
        else:
            patience += 1

        logger.info(
            "epoch %d (%.1fs) train %s | val %s | best %.5f patience %d",
            epoch, time.time() - t0,
            {k: round(v, 5) for k, v in train_avg.items()},
            {k: round(v, 5) for k, v in val_avg.items()},
            best_val, patience)

        if improved or (epoch % save_frequency == 0):
            on_checkpoint(epoch, best_val, patience, curves)

        if patience >= early_stop_patience:
            logger.info("Early stop patience achieved at epoch %d", epoch)
            break
    return curves, best_val


class Trainer:
    """What the trainers share: their state as one dict (`state.pt`),
    the best snapshot (`best.pt`), and `fit` around `run_training` with
    the JAX package's checkpoint, meta.json and resume rules.

    A subclass sets `device`, `seed`, `models` (name -> module, the
    trainer's whole state), `optimizers` (name -> optimizer),
    `schedulers` (meta.json key -> (PlateauScheduler, optimizer name))
    and `best_models` (the names `best.pt` holds, or it overrides
    `best_snapshot`), and defines `train_step`, `eval_step` and
    `meta_fields`. It may set `loss_key`, the val metric that drives the
    schedulers, the best snapshot and early stop, and override
    `resume_meta`, which reads what it wrote into meta.json back on
    resume.

    Data parallelism: in a process group, `batch_to_device` keeps this
    rank's rows of the global batch, a train step calls
    `reduce_gradients` on each optimizer after its backward, `fit` starts
    every rank from rank 0's state, and only rank 0 writes the run dir.
    """

    loss_key = "total"

    def resume_meta(self, meta: dict) -> None:
        """Restore trainer fields from the meta.json of a resumed run."""

    def state_dict(self) -> dict:
        """Weights, optimizer states and BN step counters of every model;
        the counters are not in a module's state_dict."""
        return {"models": {k: m.state_dict() for k, m in self.models.items()},
                "optimizers": {k: o.state_dict()
                               for k, o in self.optimizers.items()},
                "bn_count": {k: bn_counts(m) for k, m in self.models.items()}}

    def load_state_dict(self, state: dict) -> None:
        for k, m in self.models.items():
            m.load_state_dict(state["models"][k])
            set_bn_counts(m, state["bn_count"][k])
        for k, o in self.optimizers.items():
            o.load_state_dict(state["optimizers"][k])

    def best_snapshot(self):
        """What `best.pt` holds: name -> state_dict of `best_models`."""
        return {k: self.models[k].state_dict() for k in self.best_models}

    def batch_to_device(self, batch):
        """This rank's rows of a host batch, as float32 on the device."""
        move = lambda x: torch.as_tensor(x).to(self.device, torch.float32)
        batch = shard_batch(batch)
        return tuple(map(move, batch)) if isinstance(batch, tuple) \
            else move(batch)

    @staticmethod
    def reduce_gradients(optimizer: torch.optim.Optimizer) -> None:
        """Average the gradients of `optimizer`'s parameters over the
        ranks (nothing without a process group)."""
        average_gradients(p for group in optimizer.param_groups
                          for p in group["params"])

    def fit(self, train_loader, val_loader, epochs: int, save_dir: str,
            early_stop_patience: int, save_frequency: int, model_name: str,
            resume: bool = False, logger=None):
        """Train to `epochs` (or early stop), writing the best snapshot,
        the state, meta.json and loss_curves.json to `save_dir`. With
        `resume` and a state in `save_dir`, continue after its epoch.
        Returns (curves of the epochs run here, best val loss)."""
        logger = logger or get_logger()
        ckpt = CheckpointManager(save_dir)
        start_epoch, best_val, patience = 0, float("inf"), 0
        if resume and ckpt.has_state():
            meta = ckpt.load_meta()
            self.load_state_dict(ckpt.load_state())
            start_epoch = int(meta["epoch"]) + 1
            best_val = float(meta["best_val"])
            patience = int(meta["patience"])
            for key, (sched, _) in self.schedulers.items():
                sched.load_state_dict(meta[key])
            self.resume_meta(meta)
            logger.info("resumed from epoch %d", start_epoch)
        replicate(self.models.values())
        primary = distributed.is_primary()

        def schedulers_step(val_total):
            for sched, opt in self.schedulers.values():
                sched.step(val_total, self.optimizers[opt])

        def on_best(epoch):
            if primary:
                ckpt.save_best(self.best_snapshot())

        def on_checkpoint(epoch, best, pat, curves):
            if not primary:
                return
            ckpt.save_state(self.state_dict())
            ckpt.save_meta({
                "model_name": model_name, **self.meta_fields(),
                "epoch": epoch, "best_val": best, "patience": pat,
                **{k: s.state_dict() for k, (s, _) in self.schedulers.items()},
            })
            with open(os.path.join(save_dir, "loss_curves.json"), "w") as f:
                json.dump(curves, f)

        return run_training(
            epochs=epochs, start_epoch=start_epoch,
            train_loader=train_loader, val_loader=val_loader,
            train_step=self.train_step, eval_step=self.eval_step,
            seed=self.seed, device=self.device,
            schedulers_step=schedulers_step, on_best=on_best,
            on_checkpoint=on_checkpoint, logger=logger,
            early_stop_patience=early_stop_patience, best_val=best_val,
            patience=patience, save_frequency=save_frequency,
            loss_key=self.loss_key)
