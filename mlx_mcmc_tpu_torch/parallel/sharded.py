"""Chains sharded over ranks with pooled warmup adaptation.

Counterpart of ``mlx_mcmc_tpu/parallel/sharded.py:431-668``. One process
drives one device and runs its block of the chains through the engine
(``inference/engine.py``, ``build_sampler(..., group=...)``): rank ``r`` of
the mesh axis holds chains ``[r * C_local, (r + 1) * C_local)``. Every
random draw is keyed on the global chain index (Philox at ``(seed, chain,
step)``), so the blocks' draws are those of one ``sample()`` run over all
the chains. The warmup's adaptation statistics are pooled across the ranks
between transitions (the mean accept every warmup step, the Welford moments
at window ends, ChEES's chain means), so every rank adapts the same
tunables; under fixed tunables a sharded run gives ``sample()``'s bits.
Each transition runs as on one device, through its CUDA graphs on the card;
no collective is captured.

Every rank returns the global result: draws and info gathered across the
ranks along the chain axis (``dist.all_gather``), as a single-device run
shows them. Observation sharding (``data_axis``, ``data_specs``,
``log_prior_fn``) is ROADMAP A.10b and raises.
"""

from __future__ import annotations

import functools
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess_chunked, device_rhat
from mlx_mcmc_tpu_torch.inference import api
from mlx_mcmc_tpu_torch.inference.engine import build_sampler, data_fingerprint, jittered_starts
from mlx_mcmc_tpu_torch.ops.ravel import ravel_params
from mlx_mcmc_tpu_torch.parallel.distributed import Collectives, initialize_distributed
from mlx_mcmc_tpu_torch.parallel.mesh import chain_mesh

# Sharded runners, as ``api._RUNNER_CACHE`` keeps ``sample()``'s (the
# same key, by ``api.runner_key``, with the local chain count), keyed also
# on the group, this process's rank in it, its size and the mesh axis.
_SHARDED_CACHE: "OrderedDict[Any, Any]" = OrderedDict()


def clear_sharded_runner_cache() -> None:
    """Drop every cached sharded runner and its graphs. (The package-level
    ``clear_runner_cache`` clears this cache too.)"""
    _SHARDED_CACHE.clear()


def _mesh_axes_meta(mesh, axis: str, data_axis: Optional[str]) -> dict:
    """The mesh layout that a sharded run's checkpoint records: the chain
    and data axes' names and sizes (the reference's ``_mesh_axes_meta``).
    Pooled statistics round by layout, so only the same layout continues a
    run bit for bit."""
    names = tuple(mesh.mesh_dim_names)
    return {"axis": axis, "axis_size": int(mesh.shape[names.index(axis)]),
            "data_axis": data_axis,
            "data_axis_size": int(mesh.shape[names.index(data_axis)]) if data_axis else None}


def _tile(pool: Collectives, tree):
    """A tree of named tuples of tensors with every leaf stacked over the
    ranks: ``(world, *leaf.shape)``, rank order (the reference's tiled
    adaptation state)."""
    if isinstance(tree, tuple):
        nodes = [_tile(pool, node) for node in tree]
        return type(tree)(*nodes) if hasattr(tree, "_fields") else tuple(nodes)
    return pool.gather(tree.reshape((1,) + tuple(tree.shape)), dim=0)


def _gather_chains(pool: Collectives, x: torch.Tensor) -> torch.Tensor:
    """A ``(C_local, draws, ...)`` field of the engine (a transposed
    ``(draws, C_local, ...)`` store) over every rank's chains:
    ``(C, draws, ...)``, the same layout."""
    return pool.gather(x.transpose(0, 1), dim=1).transpose(0, 1)


def sample_sharded(
    log_prob_fn: Optional[Callable[..., torch.Tensor]],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 8,
    kernel: str = "nuts",
    seed: int = 0,
    mesh=None,
    axis: str = "chains",
    step_size="auto",
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    jitter: float = 0.0,
    device_diagnostics: bool = False,
    data=None,
    data_axis: Optional[str] = None,
    data_specs=None,
    log_prior_fn: Optional[Callable] = None,
    store_dtype=None,
    draw_chunk: Optional[int] = None,
    device=None,
    **kernel_kwargs,
) -> api.MCMCResult:
    """Run ``num_chains`` chains split over the ranks of ``mesh[axis]``
    (a ``torch.distributed`` ``DeviceMesh``, e.g. :func:`chain_mesh`; by
    default the world's ranks, a world of one where no process group
    exists), with the warmup adaptation pooled across them.

    Every rank calls it with the same arguments and gets the same global
    :class:`MCMCResult`: ``samples`` and ``info`` over all the chains, as
    ``sample()`` returns them. ``num_chains`` must be divisible by the axis
    size. The kernels, tunables, ``jitter``, ``store_dtype``, ``thin``,
    ``data`` and the kernel kwargs (``value_and_grad_fn``,
    ``init_inv_mass_diag``, ``max_tree_depth``, ...) are ``sample()``'s.
    Under fixed tunables the draws and every info field are ``sample()``'s
    bits; adaptive runs agree statistically (pooled means round
    differently). ``device=None`` means CUDA (nccl) and raises without a
    GPU; pass ``'cpu'`` for gloo on the CPU.

    ``device_diagnostics=True`` computes split R-hat and ESS per flat
    dimension on each rank's own draws, pooling only ``(D,)`` statistics
    across ranks (``diagnostics/device.py``), into ``result.device_stats``.
    ``draw_chunk=k`` runs the draws in chunks of ``k``, each gathered to
    host numpy before the next runs (draws and info as numpy arrays, the
    unchunked run's bits); it excludes ``device_diagnostics``, which needs
    every draw on the device. ``result.collectives`` counts and times the
    collectives: the adaptation's, the diagnostics' and the final gathers'
    (draws, info and the resume payload's positions and state).
    ``result.resume_payload`` carries the adaptation state tiled over the
    ranks and the mesh layout (``mesh_axes``), which ``io.save_checkpoint``
    writes; continuing it needs the sharded checkpoint paths (ROADMAP
    A.10b). Runners are cached as ``sample()``'s
    (:func:`clear_sharded_runner_cache`).
    """
    for name, value in (("data_axis", data_axis), ("data_specs", data_specs),
                        ("log_prior_fn", log_prior_fn)):
        if value is not None:
            raise NotImplementedError(f"sample_sharded({name}=...): observation sharding is not "
                                      "ported yet (ROADMAP A.10b)")
    dev = resolve_device(device)
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    if log_prob_fn is None and kernel_kwargs.get("value_and_grad_fn") is None:
        raise ValueError("pass log_prob_fn or value_and_grad_fn")
    if draw_chunk is not None:
        if draw_chunk <= 0:
            raise ValueError(f"draw_chunk must be positive, got {draw_chunk}")
        if draw_chunk >= num_samples:
            draw_chunk = None  # one chunk is the unchunked run
    if draw_chunk is not None and device_diagnostics:
        raise ValueError("draw_chunk is incompatible with device_diagnostics: device R-hat/ESS "
                         "need every draw on the device; compute host diagnostics on the "
                         "chunked result instead (result.diagnostics())")
    if mesh is None:
        initialize_distributed(device=dev)
        mesh = chain_mesh()
    if axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh.mesh_dim_names}")
    group = mesh.get_group(axis)
    pool = Collectives(group)  # the final gathers
    if num_chains % pool.world:
        raise ValueError(f"num_chains={num_chains} not divisible by mesh axis '{axis}' of size "
                         f"{pool.world}")
    local = num_chains // pool.world
    first_chain = pool.rank * local

    init_inv_mass_diag = kernel_kwargs.get("init_inv_mass_diag")
    settings = api.run_settings(kernel, num_warmup, dict(
        kernel_kwargs, step_size=step_size, adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix, target_accept=target_accept,
        store_dtype=store_dtype))
    entry = api.cached_runner(log_prob_fn, initial_params, data=data, transforms=None,
                              num_chains=local, device=dev, settings=settings,
                              build=functools.partial(build_sampler, group=group),
                              cache=_SHARDED_CACHE, key_extra=(group, pool.rank, pool.world, axis))
    run, unravel = entry["run"], entry["unravel"]
    z0, _ = ravel_params(initial_params, device=dev)
    z0_batch = z0.expand(local, z0.shape[0]).contiguous()
    if jitter > 0.0:
        z0_batch = jittered_starts(int(seed), z0_batch, jitter, first_chain=first_chain)

    results = [run(int(seed), z0_batch, data, num_samples=draw_chunk or num_samples,
                   init_inv_mass_diag=init_inv_mass_diag)]
    stats = None
    if device_diagnostics:
        diag = Collectives(group)
        draws = results[0].positions
        stats = {"r_hat": device_rhat(draws.float(), diag),
                 "n_eff": device_ess_chunked(draws, group=diag)}
    if draw_chunk is None:
        first = results[0]
        samples = unravel(_gather_chains(pool, first.positions))
        info = type(first.info)(*(_gather_chains(pool, x) for x in first.info))
    else:
        # Every chunk is gathered and fetched to the host before the next
        # one runs, which continues from the last one's final positions and
        # adaptation state through the same runner and graphs.
        parts = [_fetch(pool, unravel, results[0])]
        for offset in range(draw_chunk, num_samples, draw_chunk):
            last = results[-1]
            results.append(run(int(seed), last.final_state.position, data,
                               resume_state=(last.final_adapt, last.final_traj),
                               sample_start=offset,
                               num_samples=min(draw_chunk, num_samples - offset),
                               warmup_start=num_warmup, warmup_stop=num_warmup))
            parts.append(_fetch(pool, unravel, results[-1]))
        samples = {k: np.concatenate([p[0][k] for p in parts], axis=1) for k in parts[0][0]}
        info = type(parts[0][1])(*(np.concatenate(fields, axis=1)
                                   for fields in zip(*(p[1] for p in parts))))
    last = results[-1]
    payload = api.resume_payload(
        last, unravel, num_warmup=int(num_warmup), num_chains=int(num_chains),
        next_sample_start=int(num_samples), thin=int(settings["thin"]), kernel=kernel,
        seed=int(seed), step_size=settings["step_size"],
        adapt_step_size=settings["adapt_step_size"],
        adapt_mass_matrix=settings["adapt_mass_matrix"], target_accept=target_accept,
        store_dtype=api.dtype_name(settings["store_dtype"]),
        kernel_kwargs=api.run_kwargs(kernel, settings), has_transforms=False,
        data_fingerprint=data_fingerprint(data))
    # The global final positions; the adaptation state tiled over the
    # ranks, whose Welford moments are each rank's own between window ends.
    payload.update(flat_position=pool.gather(last.final_state.position, dim=0),
                   adapt=_tile(pool, last.final_adapt), traj=_tile(pool, last.final_traj),
                   mesh_axes=_mesh_axes_meta(mesh, axis, None))
    adaptation = [r.collectives for r in results]
    collectives = {
        "adaptation": {"count": sum(c.count for c in adaptation),
                       "ms": sum(c.ms for c in adaptation)},
        "diagnostics": ({"count": diag.count, "ms": diag.ms} if device_diagnostics
                        else {"count": 0, "ms": 0.0}),
        "gather": {"count": pool.count, "ms": pool.ms},
    }
    return api.MCMCResult(
        samples=samples,
        info=info,
        tunables=last.final_tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        host_syncs=sum(r.host_syncs for r in results),
        graph_replays=sum(r.graph_replays for r in results),
        leapfrog_counts=tuple(n for r in results for n in r.leapfrog_counts),
        probe_evals=results[0].probe_evals,
        resume_payload=payload,
        device_stats=stats,
        collectives=collectives,
    )


def _fetch(pool: Collectives, unravel, result):
    """A chunk's draws (float32) and info over every rank's chains, as
    numpy arrays."""
    samples = {k: api._host(v) for k, v in unravel(_gather_chains(pool, result.positions)).items()}
    return samples, type(result.info)(*(_gather_chains(pool, x).cpu().numpy() for x in result.info))
