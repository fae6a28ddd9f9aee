"""Core tensor ops: flat parameter vectors, streaming moments, numerics
helpers (the reference's ``mlx_mcmc_tpu/ops/__init__.py`` exports)."""

from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob, ravel_params
from mlx_mcmc_tpu_torch.ops.math import (
    WelfordState,
    safe_where_log_prob,
    welford_batch_update,
    welford_finalize,
    welford_init,
    welford_update,
)

__all__ = [
    "ravel_params",
    "make_flat_logprob",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_batch_update",
    "welford_finalize",
    "safe_where_log_prob",
]
