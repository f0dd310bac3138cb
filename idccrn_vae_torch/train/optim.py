"""Optimizers and plateau LR scheduling.

Mirrors `idccrn_vae_tpu/train/optim.py`. The reference trains with
torch.optim.Adam(lr, weight_decay=1e-3), which adds the L2 term to the
gradient (not decoupled AdamW), and ReduceLROnPlateau(mode='min',
factor=0.5, patience=3) per model (pretrained_vaes/train.py:127-130);
the JAX package's optax chain add_decayed_weights -> adam is the same
update.

`PlateauScheduler` is the JAX package's host-side plateau tracker,
acting on an optimizer's `param_groups`; its `state_dict` has the JAX
keys (`best`, `num_bad`, `cooldown_counter`), so meta.json keeps one
schema.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
              weight_decay: float = 1e-3) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate,
                            weight_decay=weight_decay)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class PlateauScheduler:
    """torch ReduceLROnPlateau('min') semantics, including the default
    threshold=1e-4 (rel) and cooldown=0 the reference relies on: a
    near-flat val loss within the relative threshold counts as NOT
    improved, so the LR still decays."""

    def __init__(self, factor: float = 0.5, patience: int = 3,
                 min_lr: float = 0.0, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.best = float("inf")
        self.num_bad = 0
        self.cooldown_counter = 0

    def _is_better(self, a: float, best: float) -> bool:
        if self.threshold_mode == "rel":
            return a < best * (1.0 - self.threshold)
        return a < best - self.threshold

    def step(self, metric: float, optimizer: torch.optim.Optimizer) -> bool:
        """Track `metric`; halve the optimizer's LR after `patience` bad
        epochs. Returns whether it reduced."""
        reduced = False
        if self._is_better(metric, self.best):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            set_learning_rate(optimizer, max(
                self.min_lr, get_learning_rate(optimizer) * self.factor))
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
            reduced = True
        return reduced

    def state_dict(self):
        return {"best": self.best, "num_bad": self.num_bad,
                "cooldown_counter": self.cooldown_counter}

    def load_state_dict(self, d):
        self.best = d["best"]
        self.num_bad = d["num_bad"]
        self.cooldown_counter = d.get("cooldown_counter", 0)
