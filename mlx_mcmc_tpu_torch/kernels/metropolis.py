"""Random-walk Metropolis-Hastings, batched over chains.

Counterpart of ``mlx_mcmc_tpu/kernels/metropolis.py:27-65``: a Gaussian
proposal scaled by ``step_size * sqrt(inv_mass_diag)`` (so mass-matrix
adaptation tunes the walk too), accepted where ``log u < delta``. As in
the NUTS step, the randomness comes in as tensors: ``noise`` ``(C, D)``
standard normals and ``U`` ``(C, 1, 4)`` uniforms whose ``U[:, 0, 0]`` is
the accept uniform (``ops/random.step_draws`` with one slot).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables, step_column


class MetropolisState(NamedTuple):
    position: torch.Tensor  # (C, D)
    log_prob: torch.Tensor  # (C,)


def make_metropolis_kernel(value: Callable[[torch.Tensor], torch.Tensor]):
    """Build ``(init_fn, step_fn)`` for ``value(Z (C, D)) -> log_prob (C,)``.

    ``step_fn(state, tunables, noise, U) -> (state, info, host_syncs)``
    reads nothing on the host (``host_syncs`` is 0).
    """

    def init_fn(position: torch.Tensor) -> MetropolisState:
        return MetropolisState(position=position, log_prob=value(position))

    def step_fn(state: MetropolisState, tunables: Tunables, noise: torch.Tensor, U: torch.Tensor):
        scale = step_column(tunables.step_size) * torch.sqrt(tunables.inv_mass_diag)
        proposal = state.position + scale * noise
        log_prob_prop = value(proposal)

        delta = log_prob_prop - state.log_prob
        # A -inf current log-prob (invalid start) always moves: -inf - -inf
        # would be NaN, so it counts as a +inf improvement.
        delta = torch.where(torch.isneginf(state.log_prob), math.inf, delta)
        accept = torch.log(U[:, 0, 0]) < delta

        new_state = MetropolisState(
            position=torch.where(accept[:, None], proposal, state.position),
            log_prob=torch.where(accept, log_prob_prop, state.log_prob),
        )
        num_chains = state.position.shape[0]
        zeros = torch.zeros((num_chains,), dtype=torch.int32, device=state.position.device)
        info = TransitionInfo(
            accept_prob=torch.exp(torch.clamp(delta, max=0.0)),
            is_accepted=accept,
            is_divergent=torch.zeros_like(accept),
            energy=-new_state.log_prob,
            log_prob=new_state.log_prob,
            num_integration_steps=zeros,
            tree_depth=zeros,
            step_size=tunables.step_size.expand(num_chains),
        )
        return new_state, info, 0

    return init_fn, step_fn
