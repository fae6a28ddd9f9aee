"""Normal (Gaussian) distribution.

Counterpart of ``mlx_mcmc_tpu/distributions/normal.py``. ``loc`` and
``scale`` may be Python floats or tensors; a Python-float scale takes its
log through ``math`` (``torch.log`` refuses floats), with JAX's values at
the edges: ``-inf`` at 0 and NaN below.
"""

from __future__ import annotations

import math

import torch

from mlx_mcmc_tpu_torch.distributions.base import Distribution

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _log(x):
    if isinstance(x, (int, float)):
        if x > 0:
            return math.log(x)
        return -math.inf if x == 0 else math.nan
    return torch.log(x)


def _shape(x):
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


class Normal(Distribution):
    """Normal distribution with location ``loc`` and scale ``scale``."""

    def __init__(self, loc, scale):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(_shape(self.loc), _shape(self.scale)))

    def log_prob(self, value):
        z = (value - self.loc) / self.scale
        return -0.5 * z * z - _log(self.scale) - _HALF_LOG_2PI

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
        return _HALF_LOG_2PI + 0.5 + _log(self.scale)

    def __repr__(self):  # pragma: no cover
        return f"Normal(loc={self.loc}, scale={self.scale})"
