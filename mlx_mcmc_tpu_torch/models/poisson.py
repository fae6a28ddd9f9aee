"""Hierarchical Poisson event rates, with or without per-count covariates.

Counterpart of ``make_poisson_event_rates`` in
``mlx_mcmc_tpu/models/poisson.py``, with the same recipe, drawn from numpy's
generator because the port cannot use ``jax.random`` (the data are not the
reference's dataset):

    mu ~ N(0, 5);  log_tau ~ N(0, 1);  theta_raw_g ~ N(0, 1)
    theta_g = mu + tau * theta_raw_g
    y_gi ~ Poisson(exp(theta_g + x_gi . beta))

with ``x_gi ~ 0.5 N(0, 1)`` and ``beta ~ N(0, 1)`` (true beta ``0.3 N(0, 1)``)
when ``covariate_dim > 0``. ``log_prob`` is the full-data density of either
variant, one reduction over all G*n counts, the linear predictor in full
float32 (bf16-class rounding there collapses adaptation, DESIGN.md §4b). The
fused value+grad of the covariate variant is ``ops/poisson.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.distributions import Normal


class PoissonSpec(NamedTuple):
    log_prob: Callable
    initial_params: dict
    y: torch.Tensor  # (G, n) counts as float32
    X: Optional[torch.Tensor]  # (G, n, K) covariates or None
    truth: dict


def poisson_log_prob(y: torch.Tensor, X: Optional[torch.Tensor] = None) -> Callable:
    """The full-data log density over ``{mu, log_tau, theta_raw[, beta]}``
    for counts ``y (G, n)`` and covariates ``X (G, n, K)`` (or None)."""
    log_y_fact = torch.lgamma(y + 1.0).sum()

    def log_prob(params):
        mu, log_tau, theta_raw = params["mu"], params["log_tau"], params["theta_raw"]
        theta = mu + torch.exp(log_tau) * theta_raw  # (G,)
        s = theta[:, None]
        lp = Normal(0.0, 5.0).log_prob(mu)
        lp = lp + Normal(0.0, 1.0).log_prob(log_tau)
        lp = lp + Normal(0.0, 1.0).log_prob(theta_raw).sum()
        if X is not None:
            beta = params["beta"]
            s = s + X @ beta  # (G, n)
            lp = lp + Normal(0.0, 1.0).log_prob(beta).sum()
        return lp + (y * s - torch.exp(s)).sum() - log_y_fact

    return log_prob


def make_poisson_event_rates(
    num_groups: int = 1000,
    obs_per_group: int = 100,
    covariate_dim: int = 0,
    seed: int = 0,
    true_mu: float = 1.0,
    true_tau: float = 0.5,
    device=None,
) -> PoissonSpec:
    """Hierarchical Poisson counts with non-centered log-rates (see the
    module docstring); ``truth`` holds mu, tau and, with covariates, beta."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    f32 = np.float32
    true_theta = f32(true_mu) + f32(true_tau) * rng.standard_normal(num_groups, dtype=f32)
    truth = {"mu": true_mu, "tau": true_tau}
    initial = {
        "mu": torch.zeros((), device=dev),
        "log_tau": torch.zeros((), device=dev),
        "theta_raw": torch.zeros(num_groups, device=dev),
    }
    X = None
    log_rate = np.broadcast_to(true_theta[:, None], (num_groups, obs_per_group))
    if covariate_dim > 0:
        X_np = f32(0.5) * rng.standard_normal((num_groups, obs_per_group, covariate_dim), dtype=f32)
        true_beta = f32(0.3) * rng.standard_normal(covariate_dim, dtype=f32)
        log_rate = true_theta[:, None] + X_np @ true_beta
        X = torch.from_numpy(X_np).to(dev)
        truth["beta"] = torch.from_numpy(true_beta).to(dev)
        initial["beta"] = torch.zeros(covariate_dim, device=dev)
    y = torch.from_numpy(rng.poisson(np.exp(log_rate)).astype(f32)).to(dev)
    return PoissonSpec(
        log_prob=poisson_log_prob(y, X), initial_params=initial, y=y, X=X, truth=truth
    )
