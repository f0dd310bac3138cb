"""Checkpoint directories of the port, with explicit metadata.

The counterpart of `idccrn_vae_tpu/train/checkpoint.py`: the same
``meta.json`` (the JAX package's schema: model configs under
``config`` / ``pre_config`` / ``noisy_config`` / ``enc_config`` /
``dec_config``, ``datanorm``, training counters), with the tensors in
``torch.save`` files instead of orbax trees.

Layout:
  <dir>/meta.json
  <dir>/state.pt      training state (the supervised family's `model`)
  <dir>/best.pt       best-val-loss snapshot of the weights
  <dir>/loss_curves.json   per-epoch train/val metrics (trainers)

``best.pt`` holds a dict with the top-level keys of the JAX package's
``best`` tree — ``noisy_enc`` (and ``clean_enc`` / ``noise_enc``) for an
NSVAE run, ``enc`` / ``dec`` for a pretrained VAE, ``encoder`` /
``decoder`` / ``noise_decoder`` for phase 2 — each a port state_dict
under the reference's names; for the supervised family it is the bare
state_dict. A trainer's ``state.pt`` (`train/loop.Trainer.state_dict`)
holds ``models`` (name -> state_dict), ``optimizers`` (name -> torch
optimizer state_dict, learning rate included) and ``bn_count`` (name ->
the BN step counters, which no state_dict carries). Files are read with
``torch.load(weights_only=True)``, so loading a checkpoint runs no
pickled code, and land on the CPU; the trainers restore them by name,
so no `like` template is needed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch


def _to_jsonable(obj):
    if dataclasses.is_dataclass(obj):
        return {k: _to_jsonable(v) for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


def _to_cpu(tree: Any) -> Any:
    """Tensors and arrays -> contiguous CPU tensors, through dicts,
    lists and tuples (what `torch.load(weights_only=True)` reads back)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().contiguous()
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    # -- metadata ----------------------------------------------------------
    def save_meta(self, meta: dict) -> None:
        with open(os.path.join(self.directory, "meta.json"), "w") as f:
            json.dump(_to_jsonable(meta), f, indent=2, default=str)

    def load_meta(self) -> dict:
        with open(os.path.join(self.directory, "meta.json")) as f:
            return json.load(f)

    # -- tensors -----------------------------------------------------------
    def _path(self, name: str) -> str:
        return os.path.join(self.directory, f"{name}.pt")

    def _save_tree(self, name: str, tree: Any) -> None:
        # write then rename: an interrupted save leaves the old file
        tmp = self._path(name) + ".tmp"
        torch.save(_to_cpu(tree), tmp)
        os.replace(tmp, self._path(name))

    def _load_tree(self, name: str) -> Any:
        return torch.load(self._path(name), map_location="cpu",
                          weights_only=True)

    def save_state(self, state: Any) -> None:
        self._save_tree("state", state)

    def load_state(self) -> Any:
        return self._load_tree("state")

    def save_best(self, variables: Any) -> None:
        self._save_tree("best", variables)

    def load_best(self) -> Any:
        return self._load_tree("best")

    def has_state(self) -> bool:
        return os.path.exists(self._path("state"))

    def has_best(self) -> bool:
        return os.path.exists(self._path("best"))


def datanorm_to_meta(datanorm):
    """(mean (F,2), std (F,2)) -> JSON-serializable meta entry (or None).

    Persisting the stats WITH the checkpoint fixes a reference footgun:
    its hyperparameters round-trip through dir names and config mean/std
    paths, and test_prevae.py:549-555 silently rebuilds VAEs without
    data_mean/std, evaluating a datanorm-trained model un-normalized."""
    if datanorm is None:
        return None
    return {"mean": torch.as_tensor(datanorm[0]).cpu().numpy().tolist(),
            "std": torch.as_tensor(datanorm[1]).cpu().numpy().tolist()}


def datanorm_from_meta(meta: dict):
    """Inverse of datanorm_to_meta; tolerates pre-datanorm metas."""
    dn = meta.get("datanorm")
    if not dn:
        return None
    return (np.asarray(dn["mean"], np.float32),
            np.asarray(dn["std"], np.float32))
