"""Chain initialization: a short Adam ascent on the log density per chain.

Counterpart of ``mlx_mcmc_tpu/inference/init_strategies.py``
(``init_strategy='map'``): every chain starts from its own jittered point
and climbs for ``num_steps`` Adam steps, all chains at once through the
batched value+grad, so warmup starts near the mode.

Adam is ``ops.math.adam_update``, ``optax.adam``'s step (b1 0.9, b2 0.999,
eps 1e-8, bias-corrected moments). The jitter normals come from Philox at
chain ``i``'s reserved step :data:`MAP_JITTER_STEP`, beside
``engine.JITTER_STEP``: a chain's start does not depend on the chain count
(the reference draws one joint ``(C, D)`` normal from its init key), so
runs agree with the reference statistically, not draw for draw.
"""

from __future__ import annotations

from typing import Callable

import torch

from mlx_mcmc_tpu_torch.ops.math import adam_update
from mlx_mcmc_tpu_torch.ops.random import step_draws

# Reserved step index of the MAP init's jitter: neither a sampling step,
# the probe's (0x7FFFFFFF) nor the jittered starts' (0x7FFFFFFE).
MAP_JITTER_STEP = 0x7FFFFFFD


def map_initialize(
    value_and_grad: Callable[[torch.Tensor], tuple],
    z0_batch: torch.Tensor,
    seed: int,
    *,
    num_steps: int = 200,
    learning_rate: float = 0.05,
    jitter: float = 1.0,
) -> torch.Tensor:
    """``(C, D)`` starts after ``num_steps`` Adam steps of ascent on
    ``value_and_grad(Z) -> (log_prob (C,), grad (C, D))`` from
    ``z0_batch + jitter * N(0, 1)``. Non-finite gradients count as 0; a
    chain whose optimized log density is not finite keeps its ``z0_batch``
    row. Reads nothing on the host."""
    chains = torch.arange(z0_batch.shape[0], device=z0_batch.device)
    noise, _ = step_draws(seed, chains, MAP_JITTER_STEP, z0_batch.shape[1], 0)
    z = z0_batch + jitter * noise
    m = v = (torch.zeros_like(z),)
    for count in range(1, num_steps + 1):
        _, grad = value_and_grad(z)
        # the loss is -log_prob
        (z,), m, v = adam_update((z,), (-grad,), m, v, count, learning_rate)
    log_prob, _ = value_and_grad(z)
    return torch.where(torch.isfinite(log_prob)[:, None], z, z0_batch)
