"""Chains sharded over ranks with pooled warmup adaptation, and observations
sharded over a second mesh axis.

Counterpart of ``mlx_mcmc_tpu/parallel/sharded.py``. One process drives one
device and runs its block of the chains through the engine
(``inference/engine.py``, ``build_sampler(..., group=...)``): rank ``r`` of
the chain axis holds chains ``[r * C_local, (r + 1) * C_local)``. Every
random draw is keyed on the global chain index (Philox at ``(seed, chain,
step)``), so the blocks' draws are those of one ``sample()`` run over all
the chains. The warmup's adaptation statistics are pooled across the ranks
of the chain axis between transitions (the mean accept every warmup step,
the Welford moments at window ends, ChEES's chain means), so every rank
adapts the same tunables; under fixed tunables a sharded run gives
``sample()``'s bits. Each transition runs as on one device, through its
CUDA graphs on the card.

Observation sharding (``data_axis``): the ranks of the data axis hold the
same chains and each keeps a contiguous block of the observations
(:func:`shard_data`). Every evaluation sums the shard-local likelihood and
its gradient over the data axis with one explicit ``all_reduce`` of a
``(C, D + 1)`` buffer, then adds ``log_prior_fn``'s value and gradient once.
Nothing differentiates through the collective: ``all_reduce`` has no
autograd rule, so a gradient taken through it would be the shard's own.
The collective is inside every value+grad, so on the card it is captured
with the transition's graphs and replayed with them; its launches are
counted as a kernel's are (``_capture.count_launch``). Data peers draw the
same Philox numbers (keyed on the chain group's numbering) and adapt the
same tunables, and NUTS runs its static schedule there, so every rank of a
data group makes the same collectives in the same order.

Every rank returns the global result: draws and info gathered across the
chain axis (``dist.all_gather``), as a single-device run shows them.
"""

from __future__ import annotations

import functools
import math
import warnings
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from mlx_mcmc_tpu_torch import _capture
from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess_chunked, device_rhat
from mlx_mcmc_tpu_torch.inference import api, graphs
from mlx_mcmc_tpu_torch.inference.engine import (
    build_sampler,
    data_fingerprint,
    data_key,
    jittered_starts,
    make_batched_value,
    make_batched_value_and_grad,
)
from mlx_mcmc_tpu_torch.ops.glm import fused_data_specs, transpose_f32
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob, ravel_params
from mlx_mcmc_tpu_torch.parallel.distributed import Collectives, initialize_distributed
from mlx_mcmc_tpu_torch.parallel.mesh import chain_mesh

# Sharded runners, as ``api._RUNNER_CACHE`` keeps ``sample()``'s (the
# same key, by ``api.runner_key``, with the local chain count), keyed also
# on the groups, this process's ranks in them, their sizes and the axes.
_SHARDED_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
# Each rank's data shard and the data-axis value+grad over it, by the
# global data's identity, the specs, the functions and the data group: a
# later call with the same finds the same shard and function, so it finds
# the same runner and replays its graphs (a resume captures nothing).
_DATA_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_DATA_CACHE_MAX = 16


def clear_sharded_runner_cache() -> None:
    """Drop every cached sharded runner and its graphs, and the data shards
    and data-axis value+grads. (The package-level ``clear_runner_cache``
    clears them too.)"""
    _SHARDED_CACHE.clear()
    _DATA_CACHE.clear()


def mesh_axes_meta(mesh, axis: str, data_axis: Optional[str]) -> dict:
    """The mesh layout that a sharded run's checkpoint records: the chain
    and data axes' names and sizes (the reference's ``_mesh_axes_meta``).
    Pooled statistics round by layout, so only the same layout continues a
    run bit for bit."""
    names = tuple(mesh.mesh_dim_names or ())

    def size(name):
        return int(mesh.shape[names.index(name)]) if name in names else None

    return {"axis": axis, "axis_size": size(axis), "data_axis": data_axis,
            "data_axis_size": size(data_axis) if data_axis else None}


# ---------------------------------------------------------------------------
# Observation sharding: data specs, shards, the data-axis value+grad
# ---------------------------------------------------------------------------


def _is_fused_glm(data) -> bool:
    """A fused-GLM data dict (``ops.glm.prepare_fused_*_data``)."""
    return isinstance(data, dict) and {"Xp", "yp", "dim"} <= set(data)


def default_data_specs(data, size: int, data_axis: str = "data"):
    """The placements :func:`sample_sharded` takes where ``data_specs`` is
    not given, as the reference chooses them (its ``sharded.py:376-410``):
    a fused-GLM dict's :func:`ops.glm.fused_data_specs`; otherwise
    ``Shard(0)`` for every tensor whose leading axis divides by the data
    axis' ``size``, and ``Replicate()`` for the rest, with a warning that
    names the tensors replicated (scalars and non-tensors replicate
    silently)."""
    if _is_fused_glm(data):
        return fused_data_specs(data, data_axis)
    replicated = []

    def spec(node, path):
        if isinstance(node, dict):
            return {k: spec(v, f"{path}[{k!r}]") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(spec(v, f"{path}[{i}]") for i, v in enumerate(node))
        if isinstance(node, torch.Tensor) and node.dim() >= 1:
            if node.shape[0] > 0 and node.shape[0] % size == 0:
                return Shard(0)
            replicated.append(path)
        return Replicate()

    specs = spec(data, "")
    if replicated:
        warnings.warn(
            f"sample_sharded: replicating data leaves whose leading axis is not divisible by the "
            f"{data_axis!r} mesh axis ({size}): {replicated}. Pass data_specs to control this "
            "explicitly.", stacklevel=3)
    return specs


def shard_data(data, specs, rank: int, size: int):
    """Rank ``rank``'s part of ``data`` over a data axis of ``size`` ranks.

    ``specs`` is ``data``'s tree (dicts, lists, tuples) with a placement at
    each leaf: ``torch.distributed.tensor.Shard(dim)`` keeps the rank's
    contiguous block of ``size`` equal blocks along ``dim`` (which must
    divide), ``Replicate()`` the whole leaf; a leaf that is no tensor must
    replicate. A fused-GLM dict's ``XpT`` (X^T of f32 X) is made again
    from the shard's own rows (``ops.glm.transpose_f32``), never sliced."""
    def part(node, spec, path):
        if isinstance(node, dict):
            if not isinstance(spec, dict) or set(spec) != set(node):
                raise ValueError(f"data_specs{path}: {spec!r} does not match the data's keys "
                                 f"{sorted(node)}")
            remade = _is_fused_glm(node) and "XpT" in node and isinstance(spec["Xp"], Shard)
            out = {k: part(v, spec[k], f"{path}[{k!r}]") for k, v in node.items()
                   if not (remade and k == "XpT")}
            if remade:
                out["XpT"] = transpose_f32(out["Xp"])
            return out
        if isinstance(node, (list, tuple)):
            if not isinstance(spec, (list, tuple)) or len(spec) != len(node):
                raise ValueError(f"data_specs{path}: {spec!r} does not match the data's "
                                 f"{len(node)} entries")
            return type(node)(part(v, s, f"{path}[{i}]")
                              for i, (v, s) in enumerate(zip(node, spec)))
        if isinstance(spec, Replicate):
            return node
        if not isinstance(spec, Shard):
            raise ValueError(f"data_specs{path}: {spec!r} is not Shard(dim) or Replicate()")
        if not isinstance(node, torch.Tensor) or not 0 <= spec.dim < node.dim():
            raise ValueError(f"data_specs{path}: {spec!r} for a leaf of no such axis")
        if node.shape[spec.dim] % size:
            raise ValueError(f"data{path}: axis {spec.dim} of size {node.shape[spec.dim]} does not "
                             f"divide into {size} shards (prepare the data with num_shards="
                             f"{size}, or pass data_specs)")
        block = node.shape[spec.dim] // size
        return node.narrow(spec.dim, rank * block, block).contiguous()

    return part(data, specs, "")


def _specs_key(specs):
    """A hashable key of a specs tree, or None."""
    if specs is None or isinstance(specs, (Shard, Replicate)):
        return specs
    if isinstance(specs, dict):
        items = tuple((k, _specs_key(v))
                      for k, v in sorted(specs.items(), key=lambda kv: str(kv[0])))
        return None if any(v is None for _, v in items) else ("dict", items)
    if isinstance(specs, (list, tuple)):
        items = tuple(_specs_key(v) for v in specs)
        return None if any(v is None for v in items) else ("seq", items)
    return None


def _data_axis_vag(log_prob_fn, value_and_grad_fn, log_prior_fn, example, shard, kernel: str,
                   group, device):
    """``vag(Z, shard) -> (value (C,), grad (C, D))`` of the whole
    log density from this rank's ``shard``: the shard-local likelihood
    and gradient (``value_and_grad_fn(Z, shard)``, else autograd of
    ``log_prob_fn(params, shard)`` under ``vmap``), summed over ``group``
    by one explicit ``all_reduce`` of the ``(C, D + 1)`` pair, then
    ``log_prior_fn``'s value and gradient added once; NaN becomes -inf
    after the sum. For Metropolis the value alone (``grad`` None): no
    gradient is taken. ``vag.sum_over_shards.launches`` counts the
    collectives (a captured one at each replay). Graph-safe where the local
    part and the prior both are."""
    metropolis = kernel == "metropolis"
    if value_and_grad_fn is not None:
        def local(Z):
            return value_and_grad_fn(Z, shard)

        local_safe = graphs.captures(value_and_grad_fn)
    else:
        flat_local, _, _ = make_flat_logprob(log_prob_fn, example, data_aware=True, device=device)
        local = (make_batched_value if metropolis else make_batched_value_and_grad)(flat_local,
                                                                                      shard)
        local_safe = graphs.captures(local)
    prior = None
    if log_prior_fn is not None:
        flat_prior, _, _ = make_flat_logprob(log_prior_fn, example, device=device)
        prior = (make_batched_value if metropolis else make_batched_value_and_grad)(flat_prior)

    def sum_over_shards(buf: torch.Tensor) -> None:
        _capture.count_launch(sum_over_shards)
        dist.all_reduce(buf, group=group)

    sum_over_shards.launches = 0

    def vag(Z: torch.Tensor, data):
        del data  # the shard this function was made for
        out = local(Z)
        if metropolis:
            value = (out[0] if isinstance(out, tuple) else out).reshape(-1, 1).clone()
            sum_over_shards(value)
            value, grad = value[:, 0], None
            if prior is not None:
                value = value + prior(Z)
        else:
            buf = torch.cat([out[0].reshape(-1, 1), out[1]], dim=1)
            sum_over_shards(buf)
            value, grad = buf[:, 0], buf[:, 1:]
            if prior is not None:
                prior_value, prior_grad = prior(Z)
                value, grad = value + prior_value, grad + prior_grad
            else:
                grad = grad.contiguous()
        return torch.where(torch.isnan(value), -math.inf, value), grad

    vag.graph_safe = local_safe and (prior is None or graphs.captures(prior))
    vag.sum_over_shards = sum_over_shards
    return vag


def _data_axis_model(log_prob_fn, value_and_grad_fn, log_prior_fn, initial_params, kernel: str,
                     data, data_specs, data_axis: str, dgroup, device):
    """``(shard, vag)`` of this rank (cached in ``_DATA_CACHE`` where the
    data can be keyed): :func:`shard_data` of ``data`` by ``data_specs``
    (:func:`default_data_specs` where None) and :func:`_data_axis_vag`."""
    size, rank = dist.get_world_size(dgroup), dist.get_rank(dgroup)
    dkey, skey = data_key(data), _specs_key(data_specs)
    key = None
    if dkey is not None and (data_specs is None or skey is not None):
        key = (id(log_prob_fn), id(value_and_grad_fn), id(log_prior_fn), kernel == "metropolis",
               api._param_spec(initial_params), dkey, skey, dgroup, rank, size, data_axis, device)
        hit = api._lru_get(_DATA_CACHE, key)
        if hit is not None:
            return hit["shard"], hit["vag"]
    specs = default_data_specs(data, size, data_axis) if data_specs is None else data_specs
    shard = shard_data(data, specs, rank, size)
    vag = _data_axis_vag(log_prob_fn, value_and_grad_fn, log_prior_fn, initial_params, shard,
                         kernel, dgroup, device)
    if key is not None:
        api._lru_put(_DATA_CACHE, key, {"shard": shard, "vag": vag, "pin": (
            log_prob_fn, value_and_grad_fn, log_prior_fn, data)}, _DATA_CACHE_MAX)
    return shard, vag


# ---------------------------------------------------------------------------
# The sharded runner and what every sharded entry point does with it
# ---------------------------------------------------------------------------


def prepare(log_prob_fn, initial_params, *, num_chains: int, kernel: str, num_warmup: int, mesh,
            axis: str, data, data_axis: Optional[str], data_specs, log_prior_fn, device,
            options: dict, where: str = "sample_sharded") -> dict:
    """Everything a sharded run needs on this rank, for
    :func:`sample_sharded` and the sharded checkpoint paths
    (``io/checkpoint.py``): the mesh checked, the chain group's
    :class:`Collectives` (``pool``: the final gathers), this rank's chain
    count (``local``) and first chain, the data it passes its runner
    (``data``: its shard on a data axis), the runner-cache entry
    (``entry``, with ``run`` and ``unravel``), ``settings`` (the run's
    ``api.run_settings`` from ``options``, the caller's value+grad in
    them), the data-axis collective counter (``data_sum``, None without a
    data axis) and ``mesh_axes`` (:func:`mesh_axes_meta`). ``options``
    holds the sampler kwargs and tunables; an unknown one raises a
    ``ValueError`` that names ``where``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"{where}: mesh must be a torch.distributed DeviceMesh (chain_mesh, "
                        f"data_chain_mesh), got {type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"axis {axis!r} is not an axis of the mesh {mesh.mesh_dim_names}")
    group = mesh.get_group(axis)
    pool = Collectives(group)
    if num_chains % pool.world:
        raise ValueError(f"num_chains={num_chains} not divisible by mesh axis '{axis}' of size "
                         f"{pool.world}")
    options = dict(options)
    if data_axis is not None:
        if data is None:
            raise ValueError("data_axis requires data=... to shard")
        if data_axis not in names or data_axis == axis:
            raise ValueError(f"data_axis {data_axis!r} not in mesh axes {names} (apart from the "
                             f"chain axis {axis!r})")
        if kernel == "nuts":
            if options.get("static_schedule") is False:
                raise ValueError(
                    "kernel='nuts' with data_axis requires the static schedule (static_schedule="
                    "True, the default here): every rank of the data axis must make the same "
                    "collectives, which a tree loop that ends with its chains would not promise")
            # the fixed-trip pair loop: the same draws, no host read
            options["static_schedule"] = True
    elif data_specs is not None or log_prior_fn is not None:
        raise ValueError(f"{where}: data_specs and log_prior_fn belong to observation sharding; "
                         "pass data_axis")
    try:
        settings = api.run_settings(kernel, num_warmup, options)
    except ValueError as err:
        raise ValueError(f"{where}: {err}") from None
    runner_settings, run_data, data_sum, model = settings, data, None, log_prob_fn
    key_extra = (group, pool.rank, pool.world, axis)
    if data_axis is not None:
        dgroup = mesh.get_group(data_axis)
        run_data, vag = _data_axis_model(
            log_prob_fn, settings.get("value_and_grad_fn"), log_prior_fn, initial_params, kernel,
            data, data_specs, data_axis, dgroup, device)
        runner_settings = dict(settings, value_and_grad_fn=vag)
        data_sum, model = vag.sum_over_shards, None
        key_extra += (dgroup, dist.get_rank(dgroup), dist.get_world_size(dgroup), data_axis)
    entry = api.cached_runner(model, initial_params, data=run_data, transforms=None,
                              num_chains=num_chains // pool.world, device=device,
                              settings=runner_settings,
                              build=functools.partial(build_sampler, group=group),
                              cache=_SHARDED_CACHE, key_extra=key_extra)
    local = num_chains // pool.world
    return {"pool": pool, "local": local, "first_chain": pool.rank * local, "data": run_data,
            "entry": entry, "settings": settings, "data_sum": data_sum,
            "mesh_axes": mesh_axes_meta(mesh, axis, data_axis)}


def rank_starts(sh: dict, initial_params, seed: int, jitter: float, device) -> torch.Tensor:
    """This rank's chains' starts as ``sample()`` makes them: every chain at
    ``initial_params``, plus ``jitter`` times its own normals (keyed on its
    global index)."""
    z0, _ = ravel_params(initial_params, device=device)
    z0_batch = z0.expand(sh["local"], z0.shape[0]).contiguous()
    if jitter > 0.0:
        z0_batch = jittered_starts(int(seed), z0_batch, jitter, first_chain=sh["first_chain"])
    return z0_batch


def rank_rows(sh: dict, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global ``(C, ...)`` chain-major tensor."""
    return x[sh["first_chain"]:sh["first_chain"] + sh["local"]].contiguous()


def rank_state(sh: dict, tree):
    """This rank's row of adaptation state tiled over the chain axis's
    ranks (each rank's Welford moments are its own between window
    ends)."""
    if isinstance(tree, tuple):
        nodes = [rank_state(sh, node) for node in tree]
        return type(tree)(*nodes) if hasattr(tree, "_fields") else tuple(nodes)
    return tree[sh["pool"].rank]


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


def gather_draws(sh: dict, result):
    """A run's draws (unravelled) and info over every rank's chains."""
    pool = sh["pool"]
    samples = sh["entry"]["unravel"](_gather_chains(pool, result.positions))
    return samples, type(result.info)(*(_gather_chains(pool, x) for x in result.info))


def global_state(sh: dict, result) -> dict:
    """A run's final positions over every rank's chains and its adaptation
    state tiled over the ranks: what a sharded checkpoint holds."""
    pool = sh["pool"]
    return {"flat_position": pool.gather(result.final_state.position, dim=0),
            "adapt": _tile(pool, result.final_adapt), "traj": _tile(pool, result.final_traj)}


def collectives(sh: dict, results, data_sum_before: int, diag=None) -> dict:
    """Count and milliseconds of a run's collectives: the adaptation's,
    the device diagnostics', the final gathers' and the data axis's sums
    (counted, not timed: inside graphs no event can time them)."""
    adaptation = [r.collectives for r in results]
    data = 0 if sh["data_sum"] is None else sh["data_sum"].launches - data_sum_before
    return {
        "adaptation": {"count": sum(c.count for c in adaptation),
                       "ms": sum(c.ms for c in adaptation)},
        "diagnostics": ({"count": diag.count, "ms": diag.ms} if diag is not None
                        else {"count": 0, "ms": 0.0}),
        "gather": {"count": sh["pool"].count, "ms": sh["pool"].ms},
        "data": {"count": data, "ms": None},
    }


def payload(sh: dict, result, *, has_log_prior: bool, has_data_specs: bool, **settings) -> dict:
    """A sharded run's ``resume_payload``: ``api.resume_payload`` with the
    global final positions, the adaptation state tiled over the ranks and
    the mesh layout."""
    out = api.resume_payload(result, sh["entry"]["unravel"], **settings)
    out.update(global_state(sh, result), mesh_axes=sh["mesh_axes"],
               has_log_prior=bool(has_log_prior), has_data_specs=bool(has_data_specs))
    return out


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

    ``data_axis`` names a second mesh axis (e.g. :func:`data_chain_mesh`'s
    ``'data'``) to shard the observations over; ``data`` is required and
    every rank passes all of it. The model's contract changes as in the
    reference: ``log_prob_fn(params, data)`` (or ``value_and_grad_fn(Z,
    data)``, e.g. ``make_fused_logistic_vag(include_prior=False)``)
    returns the likelihood of the shard it is given, and the prior moves to
    ``log_prior_fn(params)``, counted once. ``data_specs`` is ``data``'s
    tree with a ``torch.distributed.tensor`` placement at each leaf,
    ``Shard(0)`` (the rank's contiguous block of rows) or ``Replicate()``;
    by default a fused-GLM dict takes ``ops.glm.fused_data_specs`` and any
    other data shards each leading axis that the data axis divides
    (:func:`default_data_specs`). NUTS runs its static schedule there
    (``static_schedule=False`` raises): keep ``max_tree_depth`` modest.
    ``result.collectives["data"]`` counts the data axis's sums.

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
    writes and ``io.resume(..., mesh=...)`` continues bit for bit on a mesh
    of the same layout. Runners are cached as ``sample()``'s
    (:func:`clear_sharded_runner_cache`).
    """
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
    sh = prepare(log_prob_fn, initial_params, num_chains=num_chains, kernel=kernel,
                 num_warmup=num_warmup, mesh=mesh, axis=axis, data=data, data_axis=data_axis,
                 data_specs=data_specs, log_prior_fn=log_prior_fn, device=dev,
                 options=dict(kernel_kwargs, step_size=step_size,
                              adapt_step_size=adapt_step_size,
                              adapt_mass_matrix=adapt_mass_matrix, target_accept=target_accept,
                              store_dtype=store_dtype))
    pool, settings, run = sh["pool"], sh["settings"], sh["entry"]["run"]
    data_sum_before = 0 if sh["data_sum"] is None else sh["data_sum"].launches
    z0_batch = rank_starts(sh, initial_params, seed, jitter, dev)
    results = [run(int(seed), z0_batch, sh["data"], num_samples=draw_chunk or num_samples,
                   init_inv_mass_diag=kernel_kwargs.get("init_inv_mass_diag"))]
    stats = diag = None
    if device_diagnostics:
        diag = Collectives(pool.group)
        draws = results[0].positions
        stats = {"r_hat": device_rhat(draws.float(), diag),
                 "n_eff": device_ess_chunked(draws, group=diag)}
    if draw_chunk is None:
        samples, info = gather_draws(sh, results[0])
    else:
        # Every chunk is gathered and fetched to the host before the next
        # one runs, which continues from the last one's final positions and
        # adaptation state through the same runner and graphs.
        parts = [_fetch(sh, results[0])]
        for offset in range(draw_chunk, num_samples, draw_chunk):
            last = results[-1]
            results.append(run(int(seed), last.final_state.position, sh["data"],
                               resume_state=(last.final_adapt, last.final_traj),
                               sample_start=offset,
                               num_samples=min(draw_chunk, num_samples - offset),
                               warmup_start=num_warmup, warmup_stop=num_warmup))
            parts.append(_fetch(sh, results[-1]))
        samples = {k: np.concatenate([p[0][k] for p in parts], axis=1) for k in parts[0][0]}
        info = type(parts[0][1])(*(np.concatenate(fields, axis=1)
                                   for fields in zip(*(p[1] for p in parts))))
    last = results[-1]
    resume = payload(
        sh, last, has_log_prior=log_prior_fn is not None, has_data_specs=data_specs is not None,
        num_warmup=int(num_warmup), num_chains=int(num_chains),
        next_sample_start=int(num_samples), thin=int(settings["thin"]), kernel=kernel,
        seed=int(seed), step_size=settings["step_size"],
        adapt_step_size=settings["adapt_step_size"],
        adapt_mass_matrix=settings["adapt_mass_matrix"], target_accept=target_accept,
        store_dtype=api.dtype_name(settings["store_dtype"]),
        kernel_kwargs=api.run_kwargs(kernel, settings), has_transforms=False,
        data_fingerprint=data_fingerprint(data))
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
        resume_payload=resume,
        device_stats=stats,
        collectives=collectives(sh, results, data_sum_before, diag),
    )


def _fetch(sh: dict, result):
    """A chunk's draws (float32) and info over every rank's chains, as
    numpy arrays."""
    samples, info = gather_draws(sh, result)
    return ({k: api._host(v) for k, v in samples.items()},
            type(info)(*(x.cpu().numpy() for x in info)))
