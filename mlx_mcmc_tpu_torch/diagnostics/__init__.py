"""Convergence diagnostics and model comparison: split R-hat and ESS on
host numpy arrays and on the device, WAIC and PSIS-LOO (the reference's
``mlx_mcmc_tpu/diagnostics/__init__.py`` exports)."""

from mlx_mcmc_tpu_torch.diagnostics.device import device_ess, device_rhat
from mlx_mcmc_tpu_torch.diagnostics.model_comparison import (
    compare,
    pointwise_log_likelihood,
    psis_loo,
    waic,
)
from mlx_mcmc_tpu_torch.diagnostics.stats import (
    effective_sample_size,
    potential_scale_reduction,
    summary_stats,
)

__all__ = [
    "effective_sample_size",
    "potential_scale_reduction",
    "summary_stats",
    "device_ess",
    "device_rhat",
    "compare",
    "pointwise_log_likelihood",
    "psis_loo",
    "waic",
]
