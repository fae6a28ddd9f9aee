"""Reference-compatible free-function samplers.

Counterpart of ``mlx_mcmc_tpu/kernels/legacy.py:24-124``: the reference's
signatures of ``metropolis_hastings``, ``hmc`` and ``nuts``, each one
chain through :func:`~mlx_mcmc_tpu_torch.inference.api.sample`, returning
``(samples_dict, acceptance_rate)`` with numpy arrays of shape
``(num_samples, *event_shape)``. ``key`` is an int seed. ``device`` (a
keyword the reference does not have) is ``sample()``'s: CUDA unless the
caller asks for the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# the module, not its ``sample``: ``kernels/__init__`` exports these functions
# and may run while ``inference.api`` is still being imported
import mlx_mcmc_tpu_torch.inference.api as api


def _finish(result) -> Tuple[Dict[str, np.ndarray], float]:
    return result.flat_samples(), result.acceptance_rate


def metropolis_hastings(
    log_prob_fn: Callable,
    initial_params: Any,
    num_samples: int = 1000,
    proposal_scale: float = 0.1,
    random_seed: int = 0,
    verbose: bool = False,
    *,
    device=None,
) -> Tuple[Dict[str, np.ndarray], float]:
    """Random-walk Metropolis with a fixed Gaussian proposal: no warmup,
    no adaptation (warmup is the facade's job)."""
    result = api.sample(
        log_prob_fn, initial_params, num_samples=num_samples, num_warmup=0, num_chains=1,
        kernel="metropolis", seed=random_seed, step_size=proposal_scale,
        adapt_step_size=False, adapt_mass_matrix=False, device=device,
    )
    if verbose:
        print(f"Metropolis: {num_samples} samples, "
              f"acceptance rate {result.acceptance_rate:.2%}")
    return _finish(result)


def hmc(
    log_prob_fn: Callable,
    initial_params: Any,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    step_size: float = 0.1,
    num_leapfrog_steps: int = 10,
    adapt_step_size: bool = True,
    target_accept: float = 0.8,
    key: Optional[int] = None,
    adapt_mass_matrix: bool = True,
    verbose: bool = False,
    *,
    device=None,
) -> Tuple[Dict[str, np.ndarray], float]:
    """HMC with dual-averaging warmup and diagonal mass adaptation."""
    result = api.sample(
        log_prob_fn, initial_params, num_samples=num_samples, num_warmup=num_warmup,
        num_chains=1, kernel="hmc", seed=key if key is not None else 0, step_size=step_size,
        num_leapfrog_steps=num_leapfrog_steps, adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix, target_accept=target_accept, device=device,
    )
    if verbose:
        print(f"HMC: {num_samples} samples after {num_warmup} warmup, "
              f"acceptance rate {result.acceptance_rate:.2%}")
    return _finish(result)


def nuts(
    log_prob_fn: Callable,
    initial_params: Any,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    step_size: float = 0.1,
    max_tree_depth: int = 10,
    adapt_step_size: bool = True,
    target_accept: float = 0.65,
    key: Optional[int] = None,
    adapt_mass_matrix: bool = True,
    verbose: bool = False,
    *,
    device=None,
) -> Tuple[Dict[str, np.ndarray], float]:
    """Iterative multinomial NUTS with dual-averaging warmup."""
    result = api.sample(
        log_prob_fn, initial_params, num_samples=num_samples, num_warmup=num_warmup,
        num_chains=1, kernel="nuts", seed=key if key is not None else 0, step_size=step_size,
        max_tree_depth=max_tree_depth, adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix, target_accept=target_accept, device=device,
    )
    if verbose:
        print(f"NUTS: {num_samples} samples after {num_warmup} warmup, "
              f"acceptance rate {result.acceptance_rate:.2%}")
    return _finish(result)
