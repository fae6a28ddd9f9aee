"""Half-normal distribution: |X| for X ~ Normal(0, scale).

Counterpart of ``mlx_mcmc_tpu/distributions/halfnormal.py``: ``-inf`` below
0 through the double-where (``ops.math.safe_where_log_prob``), so the
gradient there is zero, not NaN.
"""

from __future__ import annotations

import math

import torch

from mlx_mcmc_tpu_torch.distributions.base import (
    Distribution,
    as_float,
    as_value,
    log_param,
    param_shape,
)
from mlx_mcmc_tpu_torch.ops.math import safe_where_log_prob

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_LOG_2 = math.log(2.0)


class HalfNormal(Distribution):
    """Half-normal distribution with scale ``scale`` (support ``[0, inf)``)."""

    def __init__(self, scale):
        self.scale = scale

    @property
    def batch_shape(self):
        return param_shape(self.scale)

    def log_prob(self, value):
        value = as_value(value)

        def _lp(x):
            z = x / self.scale
            return _LOG_2 - 0.5 * z * z - log_param(self.scale) - _HALF_LOG_2PI

        return safe_where_log_prob(value >= 0, value, 1.0, _lp)

    def sample(self, generator: torch.Generator, shape=()):
        eps = torch.randn(self._sample_shape(shape), generator=generator, dtype=torch.float32,
                          device=generator.device)
        return torch.abs(eps) * self.scale

    def mean(self):
        return as_float(self.scale) * math.sqrt(2.0 / math.pi)

    def variance(self):
        return as_float(self.scale) ** 2 * (1.0 - 2.0 / math.pi)

    def mode(self):
        return torch.zeros(self.batch_shape)

    def __repr__(self):  # pragma: no cover
        return f"HalfNormal(scale={self.scale})"
