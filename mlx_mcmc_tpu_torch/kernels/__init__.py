"""Sampler kernels: batched init/step cores and the reference-compatible
free functions (the reference's ``mlx_mcmc_tpu/kernels/__init__.py``
exports).

The factories take a batched value (Metropolis) or value+grad over ``(C,
D)`` rows, ``value_and_grad(Z) -> (ll (C,), g (C, D))``, where the
reference's take the per-chain ``flat_log_prob`` and vmap it
(``kernels/nuts.py:make_nuts_kernel`` against
``mlx_mcmc_tpu/kernels/nuts.py:119``); their ``step_fn`` takes the step's
momenta or normals and uniform table from the caller (the engine's Philox
draws) in place of a PRNG key.
"""

from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables, identity_tunables
from mlx_mcmc_tpu_torch.kernels.metropolis import MetropolisState, make_metropolis_kernel
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState, make_hmc_kernel
from mlx_mcmc_tpu_torch.kernels.mala import MALAState, make_mala_kernel
from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
from mlx_mcmc_tpu_torch.kernels.chees import ChEESInfo, make_chees_kernel
from mlx_mcmc_tpu_torch.kernels.legacy import hmc, metropolis_hastings, nuts

__all__ = [
    "TransitionInfo",
    "Tunables",
    "identity_tunables",
    "MetropolisState",
    "HMCState",
    "MALAState",
    "ChEESInfo",
    "make_metropolis_kernel",
    "make_hmc_kernel",
    "make_mala_kernel",
    "make_nuts_kernel",
    "make_chees_kernel",
    "metropolis_hastings",
    "hmc",
    "nuts",
]
