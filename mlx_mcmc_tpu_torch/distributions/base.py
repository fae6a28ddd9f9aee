"""Abstract distribution contract.

Counterpart of ``mlx_mcmc_tpu/distributions/base.py``: ``log_prob(value)``
and ``sample(generator, shape=())``. Parameters broadcast (Python floats,
tensors, batched tensors); sampling takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def param_shape(x) -> Tuple[int, ...]:
    """Shape of a parameter: a tensor's, or ``()`` for a Python number."""
    return tuple(x.shape) if isinstance(x, torch.Tensor) else ()


def log_param(x):
    """``log`` of a parameter. A Python number takes ``math`` (``torch.log``
    refuses numbers), with JAX's values at the edges: ``-inf`` at 0, NaN
    below."""
    if isinstance(x, (int, float)):
        if x > 0:
            return math.log(x)
        return -math.inf if x == 0 else math.nan
    return torch.log(x)


def lgamma_param(x):
    """``lgamma`` of a parameter (a Python number through ``math``; ``inf``
    at the poles, as ``torch.lgamma`` gives)."""
    if isinstance(x, (int, float)):
        try:
            return math.lgamma(x)
        except ValueError:
            return math.inf
    return torch.lgamma(x)


def as_float(x) -> torch.Tensor:
    """A parameter as a float32 tensor (a tensor keeps its device)."""
    return torch.as_tensor(x, dtype=torch.float32)


def as_value(value) -> torch.Tensor:
    """A ``log_prob`` argument as a tensor: a tensor as it is (batched
    under ``vmap`` too), a Python number or list as float32."""
    return value if isinstance(value, torch.Tensor) else as_float(value)


class Distribution:
    """Base class for probability distributions."""

    def log_prob(self, value) -> torch.Tensor:
        """Elementwise log-density at ``value``; ``-inf`` outside the
        support, with zero (not NaN) gradients at its boundary."""
        raise NotImplementedError

    def sample(self, generator: torch.Generator, shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """Draw samples of shape ``shape + batch_shape`` from ``generator``."""
        raise NotImplementedError

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return ()

    def _sample_shape(self, shape) -> Tuple[int, ...]:
        if isinstance(shape, int):
            shape = (shape,)
        return tuple(shape) + tuple(self.batch_shape)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"{type(self).__name__}()"
