"""Metropolis-adjusted Langevin algorithm (MALA), batched over chains.

Counterpart of ``mlx_mcmc_tpu/kernels/mala.py:34-97``: one preconditioned
Euler step of the Langevin diffusion (mean ``z + (eps^2 / 2) M^-1 grad``,
covariance ``eps^2 M^-1``) with the Hastings correction for the
asymmetric proposal, one value+grad per transition. The edge rules are
the reference's: non-finite gradients become 0 in both proposal means, a
current ``log_prob`` of ``-inf`` always moves, a NaN log ratio always
rejects; ``energy`` is the new state's ``-log_prob`` and
``num_integration_steps`` is 1.

As in the Metropolis step the randomness comes in as tensors: ``noise``
``(C, D)`` raw standard normals (``ops/random.step_draws``; the forward
density is ``-0.5 * sum(noise^2)``, so they are not the mass-scaled momenta
of ``engine.step_inputs``) and ``U`` ``(C, 1, 4)`` uniforms whose
``U[:, 0, 0]`` is the accept uniform. The step reads nothing on the host,
so ``inference/graphs.GraphedStep`` captures it whole.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables, step_column
from mlx_mcmc_tpu_torch.ops.math import row_sum


class MALAState(NamedTuple):
    position: torch.Tensor  # (C, D)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D) cached d log_prob/dz: one value+grad per transition


def _finite(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(x), x, 0.0)


def make_mala_kernel(
    value_and_grad: Callable[[torch.Tensor], tuple],
    max_delta_energy: float = 1000.0,
):
    """Build ``(init_fn, step_fn)`` for preconditioned MALA on
    ``value_and_grad(Z (C, D)) -> (log_prob (C,), grad (C, D))``.

    ``step_fn(state, tunables, noise, U) -> (state, info, host_syncs)``;
    ``host_syncs`` is 0.
    """

    def init_fn(position: torch.Tensor) -> MALAState:
        log_prob, grad = value_and_grad(position)
        return MALAState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(state: MALAState, tunables: Tunables, noise: torch.Tensor, U: torch.Tensor):
        eps = step_column(tunables.step_size)
        inv_mass = tunables.inv_mass_diag
        drift = 0.5 * eps * eps * inv_mass

        mean_fwd = state.position + drift * _finite(state.grad)
        proposal = mean_fwd + eps * torch.sqrt(inv_mass) * noise
        log_prob_prop, grad_prop = value_and_grad(proposal)

        # q(a | b) = N(a; b + drift * grad(b), eps^2 M^-1): the forward log
        # density is -0.5 |noise|^2; both normalising constants cancel.
        mean_rev = proposal + drift * _finite(grad_prop)
        inv_var = 1.0 / (eps * eps * inv_mass)
        log_q_fwd = -0.5 * row_sum(noise * noise)
        log_q_rev = -0.5 * row_sum((state.position - mean_rev) ** 2 * inv_var)

        delta = log_prob_prop - state.log_prob + log_q_rev - log_q_fwd
        delta = torch.where(torch.isneginf(state.log_prob), math.inf, delta)
        delta = torch.where(torch.isnan(delta), -math.inf, delta)
        accept = torch.log(U[:, 0, 0]) < delta

        new_state = MALAState(
            position=torch.where(accept[:, None], proposal, state.position),
            log_prob=torch.where(accept, log_prob_prop, state.log_prob),
            grad=torch.where(accept[:, None], grad_prop, state.grad),
        )
        num_chains = state.position.shape[0]
        device = state.position.device
        info = TransitionInfo(
            accept_prob=torch.exp(torch.clamp(delta, max=0.0)),
            is_accepted=accept,
            is_divergent=-delta > max_delta_energy,
            energy=-new_state.log_prob,
            log_prob=new_state.log_prob,
            num_integration_steps=torch.ones((num_chains,), dtype=torch.int32, device=device),
            tree_depth=torch.zeros((num_chains,), dtype=torch.int32, device=device),
            step_size=tunables.step_size.expand(num_chains),
        )
        return new_state, info, 0

    return init_fn, step_fn
