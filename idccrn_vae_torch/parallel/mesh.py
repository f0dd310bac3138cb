"""Which rows of a global batch a rank holds, and what the ranks share.

The port of `idccrn_vae_tpu/parallel/mesh.py`. JAX shards a batch over a
1-D 'data' mesh with `P('data')`: device k holds rows
[k * B/n, (k + 1) * B/n). Here rank k of the process group holds the
same rows (`shard_batch`), every rank keeps the whole model
(`replicate`), and after a backward the ranks average their gradients
(`average_gradients`), so a step on n ranks computes what the
single-process step on the global batch computes:

  * a loss is a batch mean; the ranks' local means over equal shards
    average to the global mean, and so do their gradients;
  * the complex-BN batch statistics, the MI estimator's aggregate
    posterior and the NSVAE's mu distance span the global batch
    (`ops/batchnorm.py`, `losses/complex_gaussian.py`,
    `losses/nsvae_loss.py`, through `parallel/distributed.py`);
  * latent noise is drawn for the global batch from the generator every
    rank shares, and each rank keeps its rows (`randn_rows`), so the
    draws are the single-process step's.

Not ported: `pad_small_tpu_batch`, a workaround for an XLA:TPU bug.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional

import torch

from idccrn_vae_torch.parallel import distributed

# the un-padded row count of the global batch being sharded (None: all
# rows are real); see `padded_rows`
_real_rows: Optional[int] = None


def auto_world(batch_size: int, n_devices: Optional[int] = None,
               device=None) -> int:
    """The data-parallel world size for a batch: JAX's `auto_mesh` rule,
    the largest n <= min(requested, available) that divides batch_size.
    On CUDA the available count is the number of cards (the default
    request is all of them); on the CPU each rank is a process, so it
    is the count requested (default 1)."""
    kind = torch.device(device).type if device is not None else "cuda"
    avail = (torch.cuda.device_count() if kind == "cuda"
             else (n_devices or 1))
    n = max(1, min(n_devices or avail, avail))
    while n > 1 and batch_size % n:
        n -= 1
    return n


def shard_batch(batch):
    """This rank's contiguous rows of a global batch (a tensor or a tuple
    of tensors), as `P('data')` assigns them. A batch that the world does
    not divide raises JAX's ValueError (`jax.device_put` with a
    `P('data')` sharding refuses it the same way)."""
    n, r = distributed.world(), distributed.rank()

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(
                f"a batch of {x.shape[0]} rows is not divisible by the "
                f"{n} ranks of the data-parallel group")
        b = x.shape[0] // n
        return x[r * b : (r + 1) * b]

    if n == 1:
        return batch
    return tuple(map(rows, batch)) if isinstance(batch, tuple) else rows(batch)


def replicate(modules: Iterable[torch.nn.Module]) -> None:
    """Give every rank rank 0's parameters and buffers (the BN running
    statistics and step counters included)."""
    if not distributed.active():
        return
    with torch.no_grad():
        for m in modules:
            for t in list(m.parameters()) + list(m.buffers()):
                torch.distributed.broadcast(t.data, src=0)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each parameter's `.grad` with its mean over the ranks, in
    one flattened all-reduce (a parameter without a gradient counts as
    zeros, so every rank sends the same layout)."""
    if not distributed.active():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat)
    flat /= distributed.world()
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset : offset + n].view_as(p)
        offset += n


@contextlib.contextmanager
def padded_rows(real_rows: int):
    """Inside the block, the global batch being sharded has `real_rows`
    real rows followed by zero pad rows (sharded evaluation pads its last
    batch to a multiple of the world): `randn_rows` draws noise for the
    real rows only, as the un-padded single-process run does, and gives
    the pad rows zeros."""
    global _real_rows
    saved, _real_rows = _real_rows, real_rows
    try:
        yield
    finally:
        _real_rows = saved


def randn_rows(shape, generator: Optional[torch.Generator] = None,
               device=None, dtype=None) -> torch.Tensor:
    """`torch.randn(shape)` for a batch-major tensor whose rows are this
    rank's shard: drawn for the whole global batch from `generator`
    (which every rank holds in the same state), then this rank's rows
    kept. Without a process group it is `torch.randn(shape)`."""
    kw = dict(generator=generator, device=device, dtype=dtype)
    n = distributed.world()
    if n == 1:
        return torch.randn(shape, **kw)
    b, rest = shape[0], tuple(shape[1:])
    real = b * n if _real_rows is None else _real_rows
    full = torch.randn((real,) + rest, **kw)
    if real < b * n:
        full = torch.cat([full, full.new_zeros((b * n - real,) + rest)])
    r = distributed.rank()
    return full[r * b : (r + 1) * b]
