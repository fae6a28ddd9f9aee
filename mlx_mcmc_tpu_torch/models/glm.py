"""Logistic and Gaussian linear regression.

Counterparts of ``make_logistic_regression`` and ``make_linear_regression``
in ``mlx_mcmc_tpu/models/glm.py`` with the same recipes (X ~ N(0, 1)/sqrt(D),
beta ~ N(0, 1), then y ~ Bernoulli(sigmoid(X beta)) or
y = X beta + noise_scale N(0, 1)), drawn from numpy's generator because the
port cannot use ``jax.random``: the data are not the reference's datasets.
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


def _design(rng, num_obs: int, num_features: int, data_dtype):
    """X ~ N(0, 1) / sqrt(D) in ``data_dtype`` and beta ~ N(0, 1)."""
    X = torch.from_numpy(
        rng.standard_normal((num_obs, num_features), dtype=np.float32)
        / np.float32(np.sqrt(num_features))
    ).to(data_dtype)
    true_beta = torch.from_numpy(rng.standard_normal(num_features, dtype=np.float32))
    return X, true_beta


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
    X, true_beta = _design(rng, num_obs, num_features, data_dtype)
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


def make_linear_regression(
    num_features: int = 100,
    num_obs: int = 10_000,
    noise_scale: float = 1.0,
    seed: int = 0,
    prior_scale: float = 1.0,
    data_dtype=torch.float32,
    device=None,
) -> GLMSpec:
    """Bayesian linear regression with known noise scale: beta ~
    N(0, prior_scale), y = X beta + noise_scale N(0, 1). The posterior is
    Gaussian, so its moments can be checked in closed form. The outcomes
    are drawn from the stored (rounded) X; ``log_prob`` omits the
    normalizers, as the reference's does."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    X, true_beta = _design(rng, num_obs, num_features, data_dtype)
    noise = torch.from_numpy(rng.standard_normal(num_obs, dtype=np.float32))
    y = X.float() @ true_beta + noise_scale * noise
    X, y, true_beta = X.to(dev), y.to(dev), true_beta.to(dev)

    def log_prob(params):
        beta = params["beta"]
        resid = y - X.float() @ beta.to(X.dtype).float()
        log_lik = -0.5 * (resid * resid).sum() / noise_scale**2
        return log_lik - 0.5 * (beta * beta).sum() / prior_scale**2

    return GLMSpec(
        log_prob=log_prob,
        initial_params={"beta": torch.zeros(num_features, device=dev)},
        X=X,
        y=y,
        true_beta=true_beta,
    )
