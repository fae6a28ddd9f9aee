"""Hierarchical Poisson event rates, with or without per-count covariates.

Counterpart of ``make_poisson_event_rates`` in
``mlx_mcmc_tpu/models/poisson.py``, drawn key for key from the reference's
own threefry streams (``models/jax_random.py``), so the port samples the
reference's dataset:

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
from mlx_mcmc_tpu_torch.models import jax_random


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
    module docstring), the reference's dataset for the same arguments;
    ``truth`` holds mu, tau, the groups' log-rates theta and, with
    covariates, beta."""
    dev = resolve_device(device)
    f32 = np.float32
    k_theta, k_x, k_beta, k_y = jax_random.split(jax_random.prng_key(seed), 4)
    true_theta = f32(true_mu) + f32(true_tau) * jax_random.normal(k_theta, (num_groups,))
    truth = {"mu": true_mu, "tau": true_tau, "theta": torch.from_numpy(true_theta).to(dev)}
    initial = {
        "mu": torch.zeros((), device=dev),
        "log_tau": torch.zeros((), device=dev),
        "theta_raw": torch.zeros(num_groups, device=dev),
    }
    X = None
    log_rate = np.broadcast_to(true_theta[:, None], (num_groups, obs_per_group))
    if covariate_dim > 0:
        X_np = f32(0.5) * jax_random.normal(k_x, (num_groups, obs_per_group, covariate_dim))
        true_beta = f32(0.3) * jax_random.normal(k_beta, (covariate_dim,))
        # The K-term contraction formed in float64 and rounded once.
        xb = (X_np.astype(np.float64) @ true_beta.astype(np.float64)).astype(f32)
        log_rate = true_theta[:, None] + xb
        X = torch.from_numpy(X_np).to(dev)
        truth["beta"] = torch.from_numpy(true_beta).to(dev)
        initial["beta"] = torch.zeros(covariate_dim, device=dev)
    y = torch.from_numpy(jax_random.poisson(k_y, np.exp(log_rate)).astype(f32)).to(dev)
    return PoissonSpec(
        log_prob=poisson_log_prob(y, X), initial_params=initial, y=y, X=X, truth=truth
    )
