"""Gamma distribution (shape/rate parameterization).

Counterpart of ``mlx_mcmc_tpu/distributions/gamma.py``: the normaliser
through ``lgamma`` (on the parameters' device, or ``math`` for Python
numbers), ``-inf`` at and below 0 with a zero gradient there; samples are
``torch._standard_gamma`` draws of the generator divided by the rate.
"""

from __future__ import annotations

import math

import torch

from mlx_mcmc_tpu_torch.distributions.base import (
    Distribution,
    as_float,
    as_value,
    lgamma_param,
    log_param,
    param_shape,
)
from mlx_mcmc_tpu_torch.ops.math import safe_where_log_prob


def standard_gamma(alpha, shape, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``shape`` from ``generator``."""
    alpha = as_float(alpha).to(generator.device).expand(shape).contiguous()
    return torch._standard_gamma(alpha, generator=generator)


class Gamma(Distribution):
    """Gamma distribution with shape ``alpha`` and rate ``beta`` (mean ``alpha/beta``)."""

    def __init__(self, alpha, beta):
        self.alpha = alpha
        self.beta = beta

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.alpha), param_shape(self.beta)))

    def log_prob(self, value):
        value = as_value(value)
        a, b = self.alpha, self.beta

        def _lp(x):
            return a * log_param(b) + (a - 1.0) * torch.log(x) - b * x - lgamma_param(a)

        return safe_where_log_prob(value > 0.0, value, 1.0, _lp)

    def sample(self, generator: torch.Generator, shape=()):
        return standard_gamma(self.alpha, self._sample_shape(shape), generator) / self.beta

    def mean(self):
        return as_float(self.alpha) / as_float(self.beta)

    def variance(self):
        return as_float(self.alpha) / as_float(self.beta) ** 2

    def mode(self):
        """Mode for alpha >= 1; NaN where the density is unbounded at 0."""
        a = as_float(self.alpha)
        return torch.where(a >= 1.0, (a - 1.0) / as_float(self.beta), math.nan)

    def __repr__(self):  # pragma: no cover
        return f"Gamma(alpha={self.alpha}, beta={self.beta})"
