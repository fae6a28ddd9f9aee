"""Utilities: typed configs, profiling helpers, roofline/MFU accounting."""

from mlx_mcmc_tpu_torch.utils.config import AdaptationConfig, MeshConfig, SamplerConfig
from mlx_mcmc_tpu_torch.utils.profiling import gradient_evals, trace_to
from mlx_mcmc_tpu_torch.utils.roofline import (
    device_peaks,
    glm_vag_bytes,
    glm_vag_flops,
    roofline_report,
)

__all__ = [
    "SamplerConfig",
    "AdaptationConfig",
    "MeshConfig",
    "trace_to",
    "gradient_evals",
    "device_peaks",
    "glm_vag_flops",
    "glm_vag_bytes",
    "roofline_report",
]
