"""Inference layer: the engine, the functional API, the MCMC facade and
the other samplers (the reference's ``mlx_mcmc_tpu/inference/__init__.py``
exports)."""

from mlx_mcmc_tpu_torch.inference.api import (
    MCMCResult,
    clear_runner_cache,
    sample,
    sample_posterior_predictive,
)
from mlx_mcmc_tpu_torch.inference.engine import build_sampler, make_kernel
from mlx_mcmc_tpu_torch.inference.ensemble import sample_ensemble
from mlx_mcmc_tpu_torch.inference.mcmc import MCMC
from mlx_mcmc_tpu_torch.inference.smc import SMCResult, sample_smc
from mlx_mcmc_tpu_torch.inference.tempered import (
    TemperedResult,
    geometric_ladder,
    sample_tempered,
)
from mlx_mcmc_tpu_torch.inference.vi import ADVIResult, fit_advi

__all__ = [
    "MCMC",
    "MCMCResult",
    "sample",
    "sample_posterior_predictive",
    "clear_runner_cache",
    "build_sampler",
    "make_kernel",
    "TemperedResult",
    "geometric_ladder",
    "sample_tempered",
    "ADVIResult",
    "fit_advi",
    "sample_ensemble",
    "SMCResult",
    "sample_smc",
]
