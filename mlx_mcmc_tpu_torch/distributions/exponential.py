"""Exponential distribution with rate parameter.

Counterpart of ``mlx_mcmc_tpu/distributions/exponential.py``: ``-inf``
below 0 with a zero gradient there; samples are exponential variates of
the generator divided by the rate.
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


class Exponential(Distribution):
    """Exponential distribution with rate ``rate`` (support ``[0, inf)``)."""

    def __init__(self, rate):
        self.rate = rate

    @property
    def batch_shape(self):
        return param_shape(self.rate)

    def log_prob(self, value):
        value = as_value(value)

        def _lp(x):
            return log_param(self.rate) - self.rate * x

        return safe_where_log_prob(value >= 0.0, value, 1.0, _lp)

    def sample(self, generator: torch.Generator, shape=()):
        e = torch.empty(self._sample_shape(shape), dtype=torch.float32, device=generator.device)
        return e.exponential_(1.0, generator=generator) / self.rate

    def mean(self):
        return 1.0 / as_float(self.rate)

    def variance(self):
        return 1.0 / as_float(self.rate) ** 2

    def mode(self):
        return torch.zeros(self.batch_shape)

    def median(self):
        return math.log(2.0) / as_float(self.rate)

    def __repr__(self):  # pragma: no cover
        return f"Exponential(rate={self.rate})"
