"""Hamiltonian Monte Carlo with a fixed leapfrog count, batched over chains.

Counterpart of ``mlx_mcmc_tpu/kernels/hmc.py:33-84``: momentum refresh,
``num_leapfrog_steps`` leapfrogs (``kernels/integrators.py``), then a
Metropolis accept on the energy difference. A NaN energy difference
becomes ``-inf`` (rejected); a transition is divergent where the energy
error exceeds ``max_delta_energy``. As in the NUTS step the randomness
comes in as tensors: momenta ``r0`` ``(C, D)`` and ``U`` ``(C, 1, 4)``
uniforms whose ``U[:, 0, 0]`` is the accept uniform. The step reads
nothing on the host, so ``inference/graphs.py`` captures it whole.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.kernels.integrators import IntegratorState, leapfrog, total_energy


class HMCState(NamedTuple):
    position: torch.Tensor  # (C, D)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D) cached d log_prob/dz


def make_hmc_kernel(
    value_and_grad: Callable[[torch.Tensor], tuple],
    num_leapfrog_steps: int = 10,
    max_delta_energy: float = 1000.0,
):
    """Build ``(init_fn, step_fn)`` for HMC on
    ``value_and_grad(Z (C, D)) -> (log_prob (C,), grad (C, D))`` (the
    engine's autograd one or a fused ``value_and_grad_fn``).

    ``step_fn(state, tunables, r0, U) -> (state, info, host_syncs)``;
    ``host_syncs`` is 0.
    """

    def init_fn(position: torch.Tensor) -> HMCState:
        log_prob, grad = value_and_grad(position)
        return HMCState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(state: HMCState, tunables: Tunables, r0: torch.Tensor, U: torch.Tensor):
        inv_mass = tunables.inv_mass_diag
        start = IntegratorState(state.position, r0, state.log_prob, state.grad)
        energy0 = total_energy(start, inv_mass)
        end = start
        for _ in range(num_leapfrog_steps):
            end = leapfrog(end, tunables.step_size, inv_mass, value_and_grad)
        energy1 = total_energy(end, inv_mass)

        delta = energy0 - energy1  # log accept ratio
        delta = torch.where(torch.isnan(delta), -math.inf, delta)
        accept = torch.log(U[:, 0, 0]) < delta

        new_state = HMCState(
            position=torch.where(accept[:, None], end.z, state.position),
            log_prob=torch.where(accept, end.log_prob, state.log_prob),
            grad=torch.where(accept[:, None], end.grad, state.grad),
        )
        num_chains = state.position.shape[0]
        device = state.position.device
        info = TransitionInfo(
            accept_prob=torch.exp(torch.clamp(delta, max=0.0)),
            is_accepted=accept,
            is_divergent=-delta > max_delta_energy,
            energy=energy0,
            log_prob=new_state.log_prob,
            num_integration_steps=torch.full((num_chains,), num_leapfrog_steps,
                                             dtype=torch.int32, device=device),
            tree_depth=torch.zeros((num_chains,), dtype=torch.int32, device=device),
            step_size=tunables.step_size.expand(num_chains),
        )
        return new_state, info, 0

    return init_fn, step_fn
