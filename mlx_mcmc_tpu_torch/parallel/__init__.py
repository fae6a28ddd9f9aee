"""Sharded sampling over ``torch.distributed``: meshes of ranks, chains split
over them, pooled adaptation, observations split over a data axis (the
reference's ``mlx_mcmc_tpu/parallel/__init__.py`` exports).

One process drives one device. Chains are the leading axis of every tensor,
and each rank of a mesh's chain axis holds a block of them; warmup
statistics and device diagnostics pool with collectives of the group (nccl
on the card, gloo on the CPU). On a data axis each rank keeps a block of
the observations and every evaluation sums the likelihood over the group.
Importing the package starts no process group.
"""

from mlx_mcmc_tpu_torch.parallel.distributed import initialize_distributed
from mlx_mcmc_tpu_torch.parallel.mesh import chain_mesh, data_chain_mesh
from mlx_mcmc_tpu_torch.parallel.sharded import clear_sharded_runner_cache, sample_sharded

__all__ = [
    "chain_mesh",
    "data_chain_mesh",
    "sample_sharded",
    "clear_sharded_runner_cache",
    "initialize_distributed",
]
