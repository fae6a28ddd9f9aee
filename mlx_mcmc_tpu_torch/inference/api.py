"""Functional sampling API: ``sample(...) -> MCMCResult``.

Counterpart of ``mlx_mcmc_tpu/inference/api.py`` in the subset the main
path uses: ``data=``, ``num_chains``, ``kernel="nuts"``, ``seed``,
``step_size``, ``adapt_step_size``, ``adapt_mass_matrix``,
``max_tree_depth``, ``target_accept``, ``store_dtype``,
``value_and_grad_fn``, ``static_schedule`` and ``device``. Draws stay on
the device until numpy is asked for.

The compiled-runner cache (reference ``api.py:63-140, 331-367``) keeps, per
static configuration, the runner that ``build_sampler`` made and, inside
it, the CUDA graphs of its transition (``inference/graphs.py``), so a
repeated ``sample()`` call replays them instead of capturing them again.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.diagnostics.stats import (
    effective_sample_size,
    potential_scale_reduction,
    summary_stats,
)
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.inference.engine import build_sampler, data_key, resolve_step_size
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.ops.ravel import _leaves, make_flat_logprob, ravel_params

# Compiled-runner cache: repeated ``sample()`` calls with the same static
# configuration reuse the runner and the CUDA graphs it captured, instead
# of capturing them again. As in the reference, functions are keyed by
# identity and the entry pins them, so ids cannot be recycled while cached;
# eviction is LRU. Unlike the reference, whose ``data`` and chain count are
# jit arguments, the graphs bake in the data tensors' addresses and the
# chain count, so both are part of the key (tensors by identity and
# shape). Mutating a cached ``data`` tensor in place needs
# ``clear_runner_cache()``, as mutating what a cached closure captures
# does in the reference.
_RUNNER_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_RUNNER_CACHE_MAX = 64


def clear_runner_cache() -> None:
    """Drop every cached runner and its graphs. Call after mutating any
    object that a cached model, value+grad or ``data`` holds."""
    _RUNNER_CACHE.clear()


def _lru_get(cache: "OrderedDict", key):
    """LRU read: a hit moves to the back of the eviction queue."""
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _lru_put(cache: "OrderedDict", key, value, max_size: int) -> None:
    if len(cache) >= max_size:
        cache.popitem(last=False)  # evict least-recently-used
    cache[key] = value


def _param_spec(params) -> tuple:
    """The structure of ``params``: each leaf's path and shape."""
    return tuple((path, tuple(torch.as_tensor(v).shape)) for path, v in _leaves(params))


@dataclass
class MCMCResult:
    """Posterior draws plus per-draw sampler diagnostics.

    ``samples``: dict name -> tensor (chains, draws, *event_shape).
    ``info``: TransitionInfo with (chains, draws) tensors.
    ``tunables``: adapted step size and inverse mass diagonal.
    ``host_syncs``: device-to-host syncs the run made.
    ``graph_replays``: replays of the transition's CUDA graphs (0 where
    the transitions ran eagerly).
    """

    samples: Dict[str, torch.Tensor]
    info: TransitionInfo
    tunables: Tunables
    num_chains: int
    num_samples: int
    kernel: str = "nuts"
    host_syncs: int = 0
    graph_replays: int = 0
    _numpy_cache: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        if self._numpy_cache is None:
            self._numpy_cache = {
                k: v.detach().float().cpu().numpy() for k, v in self.samples.items()
            }
        return self._numpy_cache

    @property
    def acceptance_rate(self) -> float:
        """Mean Metropolis acceptance statistic (Stan's 'accept_stat')."""
        return float(self.info.accept_prob.float().mean())

    @property
    def divergences(self) -> int:
        return int(self.info.is_divergent.sum())

    def diagnostics(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter split R-hat (max) and effective sample size (min)."""
        out = {}
        for k, v in self.to_numpy().items():
            flat_event = v.reshape(v.shape[0], v.shape[1], -1)
            out[k] = {
                "r_hat": float(np.max(potential_scale_reduction(flat_event))),
                "n_eff": float(np.min(effective_sample_size(flat_event))),
            }
        return out

    def summary(self, credible_interval: float = 0.95) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.to_numpy().items():
            if v.ndim == 2:
                out[k] = summary_stats(v, credible_interval)
            else:
                flat_event = v.reshape(v.shape[0], v.shape[1], -1)
                for i in range(flat_event.shape[-1]):
                    out[f"{k}[{i}]"] = summary_stats(flat_event[..., i], credible_interval)
        return out


def _as_dtype(store_dtype):
    if store_dtype is None or isinstance(store_dtype, torch.dtype):
        return store_dtype
    dtype = getattr(torch, str(store_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown store_dtype {store_dtype!r}")
    return dtype


def sample(
    log_prob_fn: Optional[Callable[..., torch.Tensor]],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 1,
    kernel: str = "nuts",
    seed: int = 0,
    step_size="auto",
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    data=None,
    store_dtype=None,
    max_tree_depth: int = 10,
    value_and_grad_fn: Optional[Callable] = None,
    thin: int = 1,
    static_schedule: bool = False,
    device=None,
) -> MCMCResult:
    """Run multi-chain NUTS against a dict-of-params model.

    ``log_prob_fn(params)`` (or ``log_prob_fn(params, data)`` with
    ``data=``) returns a scalar log density. ``value_and_grad_fn(Z, data)``
    replaces autograd with a batched fused implementation; ``log_prob_fn``
    may then be None. Every chain starts at ``initial_params``; the step
    size starts from a Stan-style probe (``step_size='auto'``) or from the
    float given, and adapts with the diagonal mass matrix during warmup;
    ``adapt_step_size=False`` keeps ``step_size`` (0.1 for ``'auto'``) and
    ``adapt_mass_matrix=False`` the unit metric.
    ``store_dtype`` (e.g. ``'bfloat16'``) down-casts only the stored draws.
    ``static_schedule=True`` runs the reference's fixed-trip pair loop (the
    same draws, no host read inside a transition).
    ``device=None`` means CUDA and raises without a GPU; pass ``'cpu'`` to
    run on the CPU.

    Runners are cached (``_RUNNER_CACHE``, see ``clear_runner_cache``): a
    call with the same functions, parameter structure, settings, chain
    count, device and ``data`` tensors replays the graphs of the last one;
    a new seed or new initial values reuse them.
    """
    dev = resolve_device(device)
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    if log_prob_fn is None and value_and_grad_fn is None:
        raise ValueError("pass log_prob_fn or value_and_grad_fn")
    store = _as_dtype(store_dtype)
    step_size = resolve_step_size(step_size, adapt_step_size)
    dkey = data_key(data)
    cache_key = None if dkey is None else (
        id(log_prob_fn), id(value_and_grad_fn), _param_spec(initial_params), dkey,
        int(num_chains), kernel, int(num_samples), int(num_warmup), int(thin), step_size,
        bool(adapt_step_size), bool(adapt_mass_matrix), target_accept, store,
        int(max_tree_depth), bool(static_schedule), dev, graphs.PAIRS_PER_REPLAY,
    )
    z0, _ = ravel_params(initial_params, device=dev)
    dim = z0.shape[0]
    entry = None if cache_key is None else _lru_get(_RUNNER_CACHE, cache_key)
    if entry is None:
        flat_log_prob, _, unravel = make_flat_logprob(
            log_prob_fn, initial_params, data_aware=data is not None, device=dev
        )
        entry = {
            "run": build_sampler(
                flat_log_prob if log_prob_fn is not None else None,
                dim,
                kernel=kernel,
                num_warmup=num_warmup,
                num_samples=num_samples,
                thin=thin,
                step_size=step_size,
                adapt_step_size=adapt_step_size,
                adapt_mass_matrix=adapt_mass_matrix,
                target_accept=target_accept,
                store_dtype=store,
                max_tree_depth=max_tree_depth,
                value_and_grad_fn=value_and_grad_fn,
                static_schedule=static_schedule,
            ),
            "unravel": unravel,
            # pin what the key names by id, so no id is recycled while cached
            "pin": (log_prob_fn, value_and_grad_fn, data),
        }
        if cache_key is not None:
            _lru_put(_RUNNER_CACHE, cache_key, entry, _RUNNER_CACHE_MAX)
    run, unravel = entry["run"], entry["unravel"]
    z0_batch = z0.expand(num_chains, dim).contiguous()
    result = run(int(seed), z0_batch, data)
    return MCMCResult(
        samples=unravel(result.positions),
        info=result.info,
        tunables=result.final_tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        host_syncs=result.host_syncs,
        graph_replays=result.graph_replays,
    )
