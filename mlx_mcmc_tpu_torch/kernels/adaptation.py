"""Warmup adaptation: dual averaging + Stan-style windowed mass adaptation.

Counterpart of ``mlx_mcmc_tpu/kernels/adaptation.py``, with the same
constants (``mu = log(10 eps0)``, ``gamma = 0.05``, ``t0 = 10``,
``kappa = 0.75``, post-warmup ``eps = eps_bar``) and the same static window
schedule. The schedule is host data, so ``adaptation_update`` takes its two
flags as Python bools and branches on the host; the device sees no select.
Chains are pooled by feeding the chain-mean accept statistic and the whole
``(C, D)`` position batch to the Welford estimator; sharded over ranks,
the accept statistic comes pooled and the moments pool at window ends
(``welford_reduce``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mlx_mcmc_tpu_torch.ops.math import (
    WelfordState,
    welford_batch_update,
    welford_finalize,
    welford_init,
)


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor  # current log step size
    log_step_avg: torch.Tensor  # kappa-weighted average (used post-warmup)
    h_bar: torch.Tensor  # running error statistic
    mu: torch.Tensor  # shrinkage target log(10 * eps0)
    count: torch.Tensor  # adaptation step counter (float)


_GAMMA = 0.05
_T0 = 10.0
_KAPPA = 0.75


def da_init(step_size, device=None) -> DualAveragingState:
    log_step = torch.log(torch.as_tensor(step_size, dtype=torch.float32, device=device))
    zero = torch.zeros_like(log_step)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        h_bar=zero,
        mu=torch.log(torch.full_like(log_step, 10.0)) + log_step,
        count=zero,
    )


def da_update(state: DualAveragingState, accept_prob, target_accept) -> DualAveragingState:
    """One dual-averaging update from the latest acceptance statistic."""
    count = state.count + 1.0
    w = 1.0 / (count + _T0)
    h_bar = (1.0 - w) * state.h_bar + w * (target_accept - accept_prob)
    log_step = state.mu - torch.sqrt(count) / _GAMMA * h_bar
    log_step = torch.clamp(log_step, -10.0, 10.0)
    eta = count**-_KAPPA
    log_step_avg = eta * log_step + (1.0 - eta) * state.log_step_avg
    return DualAveragingState(log_step, log_step_avg, h_bar, state.mu, count)


def da_restart(state: DualAveragingState) -> DualAveragingState:
    """Re-anchor dual averaging after a mass-matrix update (Stan behavior)."""
    return da_init(torch.exp(state.log_step))


class WarmupSchedule(NamedTuple):
    """Static per-warmup-step flags: ``in_slow_window[t]`` accumulates draw
    t into the Welford estimator; ``window_end[t]`` refreshes the mass
    matrix and restarts dual averaging after it."""

    in_slow_window: np.ndarray  # bool (num_warmup,)
    window_end: np.ndarray  # bool (num_warmup,)


def build_schedule(
    num_warmup: int,
    init_buffer: int = 75,
    term_buffer: int = 50,
    base_window: int = 25,
    adapt_mass_matrix: bool = True,
) -> WarmupSchedule:
    """Stan-style three-phase warmup schedule; short warmups shrink the
    phases to 15%/75%/10%, and below 20 draws mass adaptation is off."""
    in_slow = np.zeros(num_warmup, dtype=bool)
    window_end = np.zeros(num_warmup, dtype=bool)
    if num_warmup < 20 or not adapt_mass_matrix:
        return WarmupSchedule(in_slow, window_end)

    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer

    # Doubling slow windows covering [init_buffer, num_warmup - term_buffer).
    slow_end = num_warmup - term_buffer
    t = init_buffer
    width = base_window
    while t < slow_end:
        if t + 3 * width > slow_end:  # the last window absorbs the remainder
            width = slow_end - t
        end = t + width
        in_slow[t:end] = True
        window_end[end - 1] = True
        t = end
        width *= 2
    return WarmupSchedule(in_slow, window_end)


class AdaptationState(NamedTuple):
    da: DualAveragingState
    welford: WelfordState
    inv_mass_diag: torch.Tensor


def adaptation_init(dim: int, step_size, inv_mass_diag=None, device=None) -> AdaptationState:
    if inv_mass_diag is None:
        inv_mass_diag = torch.ones((dim,), dtype=torch.float32, device=device)
    return AdaptationState(
        da=da_init(step_size, device=device),
        welford=welford_init(dim, device=device),
        inv_mass_diag=torch.as_tensor(inv_mass_diag, dtype=torch.float32, device=device),
    )


def adaptation_update(
    state: AdaptationState,
    mean_accept_prob: torch.Tensor,
    positions: torch.Tensor,
    in_slow_window: bool,
    window_end: bool,
    target_accept: float,
    welford_reduce: Optional[Callable[[WelfordState], WelfordState]] = None,
) -> AdaptationState:
    """One warmup-step update: dual averaging on the chain-pooled accept
    statistic, Welford accumulation of every (local) chain's position
    inside a slow window, and at a window's end a mass-matrix refresh plus
    a restart of dual averaging and of the estimator.

    ``welford_reduce`` pools the moments across ranks
    (``ops.math.welford_psum_merge``) where chains are sharded. As in the
    reference, the pooled moments make the window end's mass matrix only:
    between window ends each rank's moments are its own."""
    da = da_update(state.da, mean_accept_prob, target_accept)
    welford = state.welford
    if in_slow_window:
        welford = welford_batch_update(welford, positions)
    inv_mass = state.inv_mass_diag
    if window_end:
        inv_mass = welford_finalize(welford if welford_reduce is None else welford_reduce(welford))
        da = da_restart(da)
        welford = welford_init(
            positions.shape[-1], dtype=welford.mean.dtype, device=positions.device
        )
    return AdaptationState(da=da, welford=welford, inv_mass_diag=inv_mass)


def find_reasonable_step_size(
    accept_prob_fn: Callable[[float], float],
    init_step_size: float = 1.0,
    target: float = 0.5,
    max_doublings: int = 40,
) -> Tuple[float, int]:
    """Stan's step-size initialization: double (or halve) epsilon until the
    one-leapfrog acceptance probability crosses ``target``.

    A host loop of at most ``max_doublings`` probes; ``accept_prob_fn(eps)``
    returns the chain-mean accept probability as a Python float (one
    device-to-host sync each). Returns ``(eps, number_of_probes)``.
    """
    eps = float(np.float32(init_step_size))
    probes = 1
    going_up = accept_prob_fn(eps) > target
    done, it = False, 0
    while (
        not done and it < max_doublings and math.isfinite(eps)
        and eps > 1e-10 and eps < 1e7
    ):
        eps = eps * (2.0 if going_up else 0.5)
        a = accept_prob_fn(eps)
        probes += 1
        done = a <= target if going_up else a >= target
        it += 1
    return eps, probes
