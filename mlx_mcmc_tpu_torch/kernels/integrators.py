"""Batched leapfrog integrator over ``(C, D)`` positions and momenta.

Counterpart of ``mlx_mcmc_tpu/kernels/integrators.py``. One value+grad per
step: the closing half-kick reuses the gradient of the new position. The
value+grad has the batched contract ``vag(Z (C, D)) -> (ll (C,), g (C, D))``
and ``grad`` is d(log_prob)/dz, so the kick is ``r += 0.5 * eps * grad``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mlx_mcmc_tpu_torch.ops.math import row_sum


class IntegratorState(NamedTuple):
    z: torch.Tensor  # position (C, D)
    r: torch.Tensor  # momentum (C, D)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D)


def kinetic_energy(r: torch.Tensor, inv_mass_diag: torch.Tensor) -> torch.Tensor:
    """Per-chain ``0.5 * r^T M^{-1} r`` for diagonal M."""
    return 0.5 * row_sum(inv_mass_diag * r * r)


def total_energy(state: IntegratorState, inv_mass_diag: torch.Tensor) -> torch.Tensor:
    """Per-chain Hamiltonian ``-log_prob + kinetic``; NaN becomes +inf."""
    energy = kinetic_energy(state.r, inv_mass_diag) - state.log_prob
    return torch.where(torch.isnan(energy), math.inf, energy)


def sample_momentum(normals: torch.Tensor, inv_mass_diag: torch.Tensor) -> torch.Tensor:
    """``r ~ N(0, M)`` from explicit standard normals: ``eps * rsqrt(inv_mass)``."""
    return normals * torch.rsqrt(inv_mass_diag)


def leapfrog(
    state: IntegratorState,
    eps: torch.Tensor,
    inv_mass_diag: torch.Tensor,
    value_and_grad: Callable,
) -> IntegratorState:
    """One leapfrog step. ``eps`` is a 0-d tensor or a per-chain ``(C, 1)``
    column (NUTS integrates chains in different directions; per-row
    tunables, ``kernels/base.step_column``); ``inv_mass_diag`` is ``(D,)``
    or per row ``(C, D)``."""
    r_half = state.r + 0.5 * eps * state.grad
    z_new = state.z + eps * (inv_mass_diag * r_half)
    log_prob_new, grad_new = value_and_grad(z_new)
    r_new = r_half + 0.5 * eps * grad_new
    return IntegratorState(z_new, r_new, log_prob_new, grad_new)
