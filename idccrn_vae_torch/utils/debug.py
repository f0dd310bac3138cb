"""Runtime NaN/Inf checks.

Mirrors `idccrn_vae_tpu/utils/debug.py`:

  * `check_finite(tree, name)`: a host-side check over nested dicts,
    lists and tuples of tensors or arrays, or over a module's
    state_dict; use it between steps.
  * `checkify_finite(x, name)`: a check on one tensor inside a forward
    that returns the tensor, so it can sit in an expression.
  * `enable_global_nan_debugging()`: autograd's anomaly mode, the nearest
    counterpart of `jax_debug_nans`.

Every check raises `RuntimeError` on the host. None uses a device-side
assert (`torch._assert_async`): a failed one poisons the CUDA context,
and every later call in the process fails with it.
"""

from __future__ import annotations

from typing import Any, Iterator, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Any, path: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in JAX's flattening order: dict keys sorted, None an
    empty subtree. Path entries are written as JAX writes its keys:
    ``['key']`` for a dict key, ``[i]`` for a list or tuple index."""
    if tree is None:
        return
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (f"[{k!r}]",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"[{i}]",))
    else:
        yield path, tree


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:  # numpy has no bfloat16
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def check_finite(tree: Any, name: str = "tree") -> None:
    """Raise RuntimeError if any leaf of `tree` holds a NaN or an Inf.

    `tree`: a tensor, an array, a number, nested dicts / lists / tuples
    of them, or an `nn.Module` (its state_dict, at any level). The
    message names the first such leaf in JAX's order, its path as JAX
    writes it, and its NaN and Inf counts. Copies each leaf to the host.
    """
    for path, leaf in _leaves(tree):
        a = _host(leaf)
        if not np.isfinite(a).all():
            keys = "/".join(path)
            raise RuntimeError(
                f"NaN/Inf detected in {name}:{keys} "
                f"(nan={np.isnan(a).sum()}, inf={np.isinf(a).sum()})")


def checkify_finite(x: torch.Tensor, name: str = "value") -> torch.Tensor:
    """Return `x`; raise RuntimeError if it holds a NaN or an Inf.

    The check reads one boolean back from the device, so it waits for
    `x`. Under `torch.compile` that read is a graph break: the graph is
    split at the check, which then runs eagerly between the two compiled
    parts, and still raises. `torch.export` cannot trace a branch on a
    tensor's value and refuses the function (a data-dependent control
    flow error), so export a program without it. JAX's counterpart is
    staged into the program under `checkify`; this one stays on the host.
    """
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"NaN/Inf detected in {name}")
    return x


def enable_global_nan_debugging() -> None:
    """Autograd's anomaly mode, process-wide.

    A backward function that returns a NaN raises, and the error names
    the forward operation it belongs to with that operation's traceback.
    It does not cover: forward values (a NaN that no gradient carries,
    or that only reaches metrics, passes; use `check_finite` or
    `checkify_finite`), Infs, and gradients computed outside autograd.
    Each backward runs slower while it is on. `jax_debug_nans` instead
    re-runs any operation whose output holds a NaN, forward included.
    """
    torch.autograd.set_detect_anomaly(True)
