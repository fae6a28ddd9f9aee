"""Normal (Gaussian) distribution.

Counterpart of ``mlx_mcmc_tpu/distributions/normal.py``. ``loc`` and
``scale`` may be Python floats or tensors (``base.log_param``).
"""

from __future__ import annotations

import math

import torch

from mlx_mcmc_tpu_torch.distributions.base import Distribution, log_param, param_shape

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class Normal(Distribution):
    """Normal distribution with location ``loc`` and scale ``scale``."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.loc), param_shape(self.scale)))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - log_param(self.scale) - _HALF_LOG_2PI

    def sample(self, generator: torch.Generator, shape=()):
        eps = torch.randn(
            self._sample_shape(shape),
            generator=generator,
            dtype=torch.float32,
            device=generator.device,
        )
        return self.loc + self.scale * eps

    def mean(self):
        return torch.as_tensor(self.loc, dtype=torch.float32).expand(self.batch_shape)

    def variance(self):
        return (torch.as_tensor(self.scale, dtype=torch.float32) ** 2).expand(
            self.batch_shape
        )

    def mode(self):
        return self.mean()

    def entropy(self):
        return _HALF_LOG_2PI + 0.5 + log_param(self.scale)

    def __repr__(self):  # pragma: no cover
        return f"Normal(loc={self.loc}, scale={self.scale})"
