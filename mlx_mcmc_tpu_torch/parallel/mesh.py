"""Device meshes for sharded sampling: the world's ranks, laid out.

Counterpart of ``mlx_mcmc_tpu/parallel/mesh.py``, with the same axis names
(``("chains",)`` and ``("chains", "data")``) over
``torch.distributed.device_mesh``. One process drives one device, so a
mesh is a layout of the world's ranks, and it holds every rank: a layout
that would leave one idle raises (the reference's ``chain_mesh(n)`` takes
the first ``n`` devices instead). Without a process group, building a mesh
starts a world of one (:func:`initialize_distributed`, on the card).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from mlx_mcmc_tpu_torch.parallel.distributed import initialize_distributed


def _world() -> int:
    if not dist.is_initialized():
        initialize_distributed()
    return dist.get_world_size()


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, names: tuple, devices) -> DeviceMesh:
    world = _world()
    n = 1
    for size in shape:
        n *= size
    if n != world:
        raise ValueError(f"a mesh of shape {dict(zip(names, shape))} needs {n} ranks; the world "
                         f"has {world} (one process drives one device, and no rank may be idle)")
    if devices is None:
        return init_device_mesh(_device_type(), shape, mesh_dim_names=names)
    ranks = [int(d) for d in devices]
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices {ranks} must list each of the world's {world} ranks once")
    return DeviceMesh(_device_type(), torch.tensor(ranks).reshape(shape), mesh_dim_names=names)


def chain_mesh(num_devices: Optional[int] = None, devices: Optional[Sequence[int]] = None
               ) -> DeviceMesh:
    """1-D mesh with one 'chains' axis over the world's ranks (in the order
    of ``devices``, a sequence of every rank, where given).
    ``num_devices`` must be the world size."""
    world = _world()
    n = world if num_devices is None else int(num_devices)
    return _mesh((n,), ("chains",), devices)


def data_chain_mesh(chains: Optional[int], data: int, devices: Optional[Sequence[int]] = None
                    ) -> DeviceMesh:
    """2-D ('chains', 'data') mesh: chains x data ranks, which must be the
    world size (``chains=None``: the world over ``data``)."""
    if chains is None:
        chains = _world() // int(data)
    return _mesh((int(chains), int(data)), ("chains", "data"), devices)
