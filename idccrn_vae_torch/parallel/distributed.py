"""The process group of data-parallel runs, and its collectives.

The port of `idccrn_vae_tpu/parallel/distributed.py`. The JAX package
runs one SPMD program over a device mesh, and XLA turns its batch means
into collectives. The port runs one process per rank: one card each
(NCCL), or a Gloo process on the CPU. Every rank holds the same weights
and its rows of the same global batch (`parallel/mesh.py`), and the
code that reduces over the batch calls the collectives here:

  * `all_reduce_sum`, `batch_means` and `gather_rows` carry autograd:
    the backward of a sum over ranks is the sum over ranks of the
    incoming gradients, so a rank's loss reaches the other ranks'
    activations through the complex-BN statistics, the MI estimator and
    the NSVAE mu distance, as under XLA;
  * `all_reduce_floats` sums host numbers (epoch metrics);
  * `broadcast_object` sends rank 0's value (the run directory).

Without a process group every helper is the single-process identity:
`world()` is 1 and nothing is communicated.

Typical entry, under `torchrun` (which sets RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT):

    from idccrn_vae_torch.parallel import distributed as dist
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.initialize(device="cuda")      # NCCL; Gloo for device="cpu"
    trainer = PretrainTrainer(cfg, loss, lr)
    ...                                 # as in a single process

The training CLIs do this themselves (`cli/common.data_parallel`).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this raises instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device=None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """torch.distributed.init_process_group with the port's defaults.

    backend: NCCL when `device` is a CUDA device (the default device),
    Gloo when it is the CPU. init_method, world_size and rank default to
    the environment that `torchrun` sets ("env://"); tests pass them
    explicitly (a "file://" or "tcp://localhost:<port>" address)."""
    if backend is None:
        kind = torch.device(device).type if device is not None else "cuda"
        backend = "nccl" if kind == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, timeout=timeout)


def _rank_main(rank: int, world_size: int, init_method: str,
               backend: Optional[str], device, timeout: datetime.timedelta,
               fn: Callable, args: tuple, result_path: str) -> None:
    """One spawned rank: join the group, run fn(*args), and on rank 0
    keep its return value for the parent."""
    kind = torch.device(device).type if device is not None else "cuda"
    if kind == "cuda" and torch.device(device or "cuda").index is None:
        torch.cuda.set_device(rank)  # one card per rank
    initialize(backend, init_method, world_size, rank, device, timeout)
    try:
        out = fn(*args)
        if rank == 0:
            with open(result_path, "wb") as f:
                pickle.dump(out, f)
    finally:
        shutdown()


def spawn(fn: Callable, world_size: int, args: tuple = (),
          backend: Optional[str] = None, device=None,
          timeout: datetime.timedelta = DEFAULT_TIMEOUT,
          deadline: Optional[float] = None) -> Any:
    """Run fn(*args) on `world_size` new processes, one rank each, in a
    new process group; return rank 0's return value (pickled back).

    `fn` must be a module-level function (the processes are started
    with the "spawn" method). On CUDA, a `device` without an index gives
    rank r the card r; an explicit index puts every rank on that card.
    `timeout` bounds each collective; `deadline`, in seconds, the whole
    run: past it the ranks are killed and TimeoutError is raised. A
    rank that fails raises here (torch.multiprocessing's
    ProcessRaisedException, with the rank's traceback)."""
    with tempfile.TemporaryDirectory(prefix="idccrn_pg_") as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(world_size, f"file://{tmp}/pg", backend, device, timeout,
                  fn, tuple(args), result_path))
        stop = None if deadline is None else time.monotonic() + deadline
        while not ctx.join(timeout=None if stop is None else max(
                0.0, stop - time.monotonic())):
            if stop is not None and time.monotonic() >= stop:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(
                    f"{world_size} ranks did not finish in {deadline} s")
        with open(result_path, "rb") as f:
            return pickle.load(f)


def shutdown() -> None:
    """Destroy the process group, if there is one."""
    if active():
        dist.destroy_process_group()


def active() -> bool:
    """True inside a process group (of any size, 1 included)."""
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if active() else 1


def rank() -> int:
    return dist.get_rank() if active() else 0


def is_primary() -> bool:
    """True on the rank that writes checkpoints, logs and results."""
    return rank() == 0


def shard_file_list(files: Sequence[str],
                    process_index: Optional[int] = None,
                    process_count: Optional[int] = None) -> list:
    """Deterministic per-rank dataset shard, strided so shards stay
    balanced under sorted-by-length file lists. Shards are padded to
    EQUAL length by wrapping around to the start of the list: every rank
    must run the same number of steps, or one enters a collective its
    peers never issue. The cost is up to process_count - 1 duplicated
    files per epoch."""
    pi = rank() if process_index is None else process_index
    pc = world() if process_count is None else process_count
    files = list(files)
    if files and len(files) % pc:
        files = files + files[: pc - len(files) % pc]
    return files[pi::pc]


def local_batch_size(global_batch: int) -> int:
    pc = world()
    if global_batch % pc:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{pc} processes")
    return global_batch // pc


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (the gradient of
    each rank's input is the sum of the ranks' incoming gradients)."""
    return _AllReduceSum.apply(x) if active() else x


def batch_means(xs: Sequence[torch.Tensor],
                dim: Sequence[int]) -> List[torch.Tensor]:
    """[x.mean(dim) for x in xs], where `dim` includes the batch dim 0,
    all of the same shape: in a group, the means over the global batch,
    from one differentiable all-reduce of the stacked sums (for the
    complex-BN statistics, and for a loss term that is no batch mean of
    per-row values, such as the square root of one)."""
    if not active():
        return [x.mean(dim=dim) for x in xs]
    count = world()
    for d in dim:
        count *= xs[0].shape[d]
    sums = all_reduce_sum(torch.stack([x.sum(dim=dim) for x in xs]))
    return list(sums / count)


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The ranks' `x` concatenated along dim 0 in rank order,
    differentiable. Every rank must pass the same shape. Built on the
    sum: each rank contributes its rows in its own place and zeros
    elsewhere (adding zeros is exact), which works on every backend."""
    n = world()
    if n == 1:
        return x
    r = rank()
    zeros = torch.zeros_like(x)
    return all_reduce_sum(torch.cat([x if i == r else zeros
                                     for i in range(n)]))


def all_reduce_floats(values: Sequence[float], device) -> List[float]:
    """Host numbers summed over the ranks, in float64 (on `device`,
    which NCCL needs to be the rank's card)."""
    if not active():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return t.tolist()


def broadcast_object(obj: Any) -> Any:
    """Rank 0's `obj` on every rank (a picklable value)."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
