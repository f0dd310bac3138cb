"""Data parallelism: one process per rank in a torch.distributed process
group (NCCL on cards, Gloo on the CPU), each rank holding its rows of
every global batch, with the gradients, the complex-BN batch statistics
and the MI estimator's aggregate posterior reduced over the group."""

from idccrn_vae_torch.parallel.mesh import shard_batch, replicate  # noqa: F401
