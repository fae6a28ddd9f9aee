"""Categorical distribution over {0, ..., K-1}.

Counterpart of ``mlx_mcmc_tpu/distributions/categorical.py``: ``probs``
XOR ``logits``, normalised to log-probabilities over the last axis (the
leading axes are batch axes); ``log_prob`` gathers them with
``take_along_dim`` (a batched index under ``vmap`` too) and gives ``-inf``
for an index outside ``0..K-1`` or not whole. Samples are Gumbel-max over
uniforms of the generator.
"""

from __future__ import annotations

import math

import torch

from mlx_mcmc_tpu_torch.distributions.base import Distribution, as_float


class Categorical(Distribution):
    """Categorical distribution parameterized by ``probs`` XOR ``logits``."""

    def __init__(self, probs=None, logits=None):
        if (probs is None) == (logits is None):
            raise ValueError("Provide exactly one of `probs` or `logits`.")
        if probs is not None:
            probs = as_float(probs)
            self._log_probs = torch.log(probs / probs.sum(-1, keepdim=True))
        else:
            self._log_probs = torch.log_softmax(as_float(logits), dim=-1)

    @property
    def logits(self):
        return self._log_probs

    @property
    def probs(self):
        return torch.exp(self._log_probs)

    @property
    def num_categories(self) -> int:
        return self._log_probs.shape[-1]

    @property
    def batch_shape(self):
        return tuple(self._log_probs.shape[:-1])

    def log_prob(self, value):
        value = torch.as_tensor(value) if not isinstance(value, torch.Tensor) else value
        k = self.num_categories
        shape = torch.broadcast_shapes(value.shape, self.batch_shape)
        idx = torch.clamp(value.to(torch.int64), 0, k - 1).expand(shape)
        log_probs = self._log_probs.expand(shape + (k,))
        gathered = torch.take_along_dim(log_probs, idx[..., None], dim=-1).squeeze(-1)
        valid = (value >= 0) & (value <= k - 1) & (value == torch.floor(value))
        return torch.where(valid, gathered, -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        u = torch.rand(self._sample_shape(shape) + (self.num_categories,), generator=generator,
                       dtype=torch.float32, device=generator.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(self._log_probs.to(generator.device) + gumbel, dim=-1)

    def entropy(self):
        p = torch.exp(self._log_probs)
        return -torch.where(p > 0, p * self._log_probs, 0.0).sum(-1)

    def mode(self):
        return torch.argmax(self._log_probs, dim=-1)

    def __repr__(self):  # pragma: no cover
        return f"Categorical(num_categories={self.num_categories})"
