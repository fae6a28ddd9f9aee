"""Beta distribution on (0, 1).

Counterpart of ``mlx_mcmc_tpu/distributions/beta.py``: the normaliser
``log B(a, b)`` through ``lgamma``, ``-inf`` outside the open interval with
a zero gradient there; a sample is the ratio of two gamma draws of the
generator.
"""

from __future__ import annotations

import math

import torch

from mlx_mcmc_tpu_torch.distributions.base import (
    Distribution,
    as_float,
    as_value,
    lgamma_param,
    param_shape,
)
from mlx_mcmc_tpu_torch.distributions.gamma import standard_gamma
from mlx_mcmc_tpu_torch.ops.math import safe_where_log_prob


def _betaln(a, b):
    return lgamma_param(a) + lgamma_param(b) - lgamma_param(a + b)


class Beta(Distribution):
    """Beta distribution with concentration parameters ``alpha``, ``beta``."""

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
            return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - _betaln(a, b)

        in_support = (value > 0.0) & (value < 1.0)
        return safe_where_log_prob(in_support, value, 0.5, _lp)

    def sample(self, generator: torch.Generator, shape=()):
        out_shape = self._sample_shape(shape)
        ga = standard_gamma(self.alpha, out_shape, generator)
        gb = standard_gamma(self.beta, out_shape, generator)
        return ga / (ga + gb)

    def mean(self):
        a, b = as_float(self.alpha), as_float(self.beta)
        return a / (a + b)

    def variance(self):
        a, b = as_float(self.alpha), as_float(self.beta)
        s = a + b
        return a * b / (s * s * (s + 1.0))

    def mode(self):
        """Mode for alpha, beta > 1; NaN where the density is unbounded."""
        a, b = as_float(self.alpha), as_float(self.beta)
        interior = (a > 1.0) & (b > 1.0)
        safe_denom = torch.where(interior, a + b - 2.0, 1.0)
        return torch.where(interior, (a - 1.0) / safe_denom, math.nan)

    def entropy(self):
        a, b = as_float(self.alpha), as_float(self.beta)
        s = a + b
        return (
            _betaln(a, b)
            - (a - 1.0) * torch.digamma(a)
            - (b - 1.0) * torch.digamma(b)
            + (s - 2.0) * torch.digamma(s)
        )

    def __repr__(self):  # pragma: no cover
        return f"Beta(alpha={self.alpha}, beta={self.beta})"
