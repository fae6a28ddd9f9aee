"""Process groups for sharded sampling: one process drives one device.

Counterpart of ``mlx_mcmc_tpu/parallel/distributed.py``, on
``torch.distributed`` in place of ``jax.distributed``: nccl on the card,
gloo on the CPU (only where the caller asks for the CPU, as every entry
point of the package does). :class:`Collectives` is what the sharded paths
pool over a group with: sums, means and gathers across its ranks, each
counted and timed.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from mlx_mcmc_tpu_torch._device import resolve_device

# torchrun's variables: with all of them set, the group starts from them
# (``init_method="env://"``).
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> None:
    """Start this process's default process group (idempotent: a process
    with one keeps it).

    The backend is nccl on CUDA (``device=None``, which raises without a
    GPU) and gloo with ``device="cpu"``; nothing falls back to the other.
    On CUDA the process first takes device ``LOCAL_RANK`` (0 where unset).
    ``coordinator_address`` (``"host:port"``), ``num_processes`` and
    ``process_id`` go together, as ``init_method="tcp://host:port"``, the
    world size and this process's rank. Without them the group starts
    from torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``
    where those are set, and otherwise as a world of one on an in-process
    ``HashStore``.
    """
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    explicit = (coordinator_address, num_processes, process_id)
    if any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("pass coordinator_address, num_processes and process_id together")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


class Collectives:
    """Sums, means and gathers over the ranks of ``group``, each counted
    (``count``) and timed (:attr:`ms`): on the card by CUDA events around
    the collective on the current stream, which waits for it; on the CPU,
    where gloo's collectives return when done, by the host clock. Reading
    :attr:`ms` waits for the last collective. Nothing here reads a value on
    the host."""

    def __init__(self, group):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.count = 0
        self._events = []  # (start, end) CUDA events, one pair a collective
        self._seconds = 0.0  # the CPU collectives' host time

    def _run(self, fn, device) -> None:
        self.count += 1
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            fn()
            self._seconds += time.perf_counter() - t0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, in a new tensor."""
        y = x.detach().clone()
        self._run(lambda: dist.all_reduce(y, group=self.group), y.device)
        return y

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every rank's ``x``: :meth:`psum` over the world size
        (a world of one returns ``x``'s bits)."""
        return self.psum(x) / self.world

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order, as a
        new contiguous tensor (``x`` is made contiguous first). A tensor of
        no elements has nothing to gather: no collective runs."""
        shape = list(x.shape)
        shape[dim] *= self.world
        out = x.new_empty(shape)
        if x.numel() == 0:
            return out
        src = x.contiguous()
        parts = list(out.split(x.shape[dim], dim=dim))
        self._run(lambda: dist.all_gather(parts, src, group=self.group), x.device)
        return out

    @property
    def ms(self) -> float:
        """The collectives' total time in milliseconds."""
        if self._events:
            self._events[-1][1].synchronize()
        return self._seconds * 1e3 + sum(s.elapsed_time(e) for s, e in self._events)
