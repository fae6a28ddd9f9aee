"""Logistic regression, the main path's model.

Counterpart of ``make_logistic_regression`` in ``mlx_mcmc_tpu/models/glm.py``
with the same recipe (X ~ N(0, 1)/sqrt(D), beta ~ N(0, 1),
y ~ Bernoulli(sigmoid(X beta))), drawn from numpy's generator because the
port cannot use ``jax.random``: the data are not the reference's dataset.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.distributions import Normal


class GLMSpec(NamedTuple):
    """A generated GLM problem: model + data + truth."""

    log_prob: Callable
    initial_params: dict
    X: torch.Tensor
    y: torch.Tensor
    true_beta: torch.Tensor


def make_logistic_regression(
    num_features: int = 100,
    num_obs: int = 10_000,
    seed: int = 0,
    prior_scale: float = 1.0,
    data_dtype=torch.float32,
    device=None,
) -> GLMSpec:
    """Bayesian logistic regression: beta ~ N(0, prior_scale),
    y ~ Bernoulli(sigmoid(X beta)). ``X`` is stored in ``data_dtype``; the
    outcomes are drawn from the stored (rounded) X."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(
        rng.standard_normal((num_obs, num_features), dtype=np.float32)
        / np.float32(np.sqrt(num_features))
    ).to(data_dtype)
    true_beta = torch.from_numpy(rng.standard_normal(num_features, dtype=np.float32))
    p = torch.sigmoid(X.float() @ true_beta).numpy()
    y = torch.from_numpy((rng.random(num_obs) < p).astype(np.float32))
    X, y, true_beta = X.to(dev), y.to(dev), true_beta.to(dev)

    def log_prob(params):
        beta = params["beta"]
        s = X.float() @ beta.to(X.dtype).float()
        log_lik = (y * s - torch.logaddexp(s, torch.zeros_like(s))).sum()
        log_prior = Normal(0.0, prior_scale).log_prob(beta).sum()
        return log_lik + log_prior

    return GLMSpec(
        log_prob=log_prob,
        initial_params={"beta": torch.zeros(num_features, device=dev)},
        X=X,
        y=y,
        true_beta=true_beta,
    )
