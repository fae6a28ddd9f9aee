"""Abstract distribution contract.

Counterpart of ``mlx_mcmc_tpu/distributions/base.py``: ``log_prob(value)``
and ``sample(generator, shape=())``. Parameters broadcast (Python floats,
tensors, batched tensors); sampling takes an explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Tuple

import torch


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
