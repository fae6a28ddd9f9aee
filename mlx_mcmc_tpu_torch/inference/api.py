"""Functional sampling API: ``sample(...) -> MCMCResult``.

Counterpart of ``mlx_mcmc_tpu/inference/api.py`` in the subset the main
path uses: ``data=``, ``num_chains``, ``kernel="nuts"``, ``seed``,
``max_tree_depth``, ``target_accept``, ``store_dtype``,
``value_and_grad_fn`` and ``device``. Draws stay on the device until numpy
is asked for. The reference's compiled-runner cache has no counterpart:
PyTorch does not retrace.
"""

from __future__ import annotations

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
from mlx_mcmc_tpu_torch.inference.engine import build_sampler
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob


@dataclass
class MCMCResult:
    """Posterior draws plus per-draw sampler diagnostics.

    ``samples``: dict name -> tensor (chains, draws, *event_shape).
    ``info``: TransitionInfo with (chains, draws) tensors.
    ``tunables``: adapted step size and inverse mass diagonal.
    ``host_syncs``: device-to-host syncs the run made.
    """

    samples: Dict[str, torch.Tensor]
    info: TransitionInfo
    tunables: Tunables
    num_chains: int
    num_samples: int
    kernel: str = "nuts"
    host_syncs: int = 0
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
    target_accept: Optional[float] = None,
    data=None,
    store_dtype=None,
    max_tree_depth: int = 10,
    value_and_grad_fn: Optional[Callable] = None,
    thin: int = 1,
    device=None,
) -> MCMCResult:
    """Run multi-chain NUTS against a dict-of-params model.

    ``log_prob_fn(params)`` (or ``log_prob_fn(params, data)`` with
    ``data=``) returns a scalar log density. ``value_and_grad_fn(Z, data)``
    replaces autograd with a batched fused implementation; ``log_prob_fn``
    may then be None. Every chain starts at ``initial_params``; the step
    size starts from a Stan-style probe and adapts with the diagonal mass
    matrix during warmup.
    ``store_dtype`` (e.g. ``'bfloat16'``) down-casts only the stored draws.
    ``device=None`` means CUDA and raises without a GPU; pass ``'cpu'`` to
    run on the CPU.
    """
    dev = resolve_device(device)
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    if log_prob_fn is None and value_and_grad_fn is None:
        raise ValueError("pass log_prob_fn or value_and_grad_fn")
    flat_log_prob, z0, unravel = make_flat_logprob(
        log_prob_fn, initial_params, data_aware=data is not None, device=dev
    )
    dim = z0.shape[0]
    run = build_sampler(
        flat_log_prob if log_prob_fn is not None else None,
        dim,
        kernel=kernel,
        num_warmup=num_warmup,
        num_samples=num_samples,
        thin=thin,
        target_accept=target_accept,
        store_dtype=_as_dtype(store_dtype),
        max_tree_depth=max_tree_depth,
        value_and_grad_fn=value_and_grad_fn,
    )
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
    )
