"""Kernel protocol types: tunables and per-draw diagnostics.

Counterpart of ``mlx_mcmc_tpu/kernels/base.py``. In the port every field
carries the chains as its leading axis where it is per chain: a
``TransitionInfo`` from one step holds ``(C,)`` tensors, a stored run holds
``(C, S)`` tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Tunables(NamedTuple):
    """Adaptation-controlled sampler knobs: the leapfrog ``step_size`` (0-d
    tensor), the inverse mass diagonal ``inv_mass_diag`` (``(D,)``) and
    ``trajectory_length``, ChEES's integration length (a 0-d tensor; the
    other kernels ignore it, and it defaults to the reference's 1.0)."""

    step_size: torch.Tensor
    inv_mass_diag: torch.Tensor
    trajectory_length: torch.Tensor = 1.0


class TransitionInfo(NamedTuple):
    """Per-draw diagnostics, uniform across kernels."""

    accept_prob: torch.Tensor  # f32: mean Metropolis acceptance statistic
    is_accepted: torch.Tensor  # bool: proposal (or trajectory move) taken
    is_divergent: torch.Tensor  # bool: energy error exceeded max_delta_energy
    energy: torch.Tensor  # f32: Hamiltonian at trajectory start
    log_prob: torch.Tensor  # f32: log density of the new state
    num_integration_steps: torch.Tensor  # i32: leapfrog evals this draw
    tree_depth: torch.Tensor  # i32: NUTS tree depth
    step_size: torch.Tensor  # f32: step size used this draw
