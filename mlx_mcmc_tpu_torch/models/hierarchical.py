"""Hierarchical models: the random-intercept normal and eight schools.

Counterparts of ``make_hierarchical_normal`` and ``eight_schools`` in
``mlx_mcmc_tpu/models/hierarchical.py``. ``make_hierarchical_normal`` draws
the reference's dataset from its own threefry streams
(``models/jax_random.py``), key for key; ``num_groups=998`` is the bench's
1000-parameter hierarchical model (mu, log_tau and 998 group effects).
The centered eight schools is the divergence stress benchmark: tau's scale
sets the width of theta's posterior, so the geometry is a funnel. Every
density here declares ``graph_safe``: CUDA graphs may capture their
transitions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.distributions import Normal
from mlx_mcmc_tpu_torch.models import jax_random


class HierarchicalSpec(NamedTuple):
    log_prob: Callable
    initial_params: dict
    y: torch.Tensor
    truth: dict


def make_hierarchical_normal(
    num_groups: int = 100,
    obs_per_group: int = 100,
    seed: int = 0,
    true_mu: float = 1.0,
    true_tau: float = 0.5,
    noise_scale: float = 1.0,
    device=None,
) -> HierarchicalSpec:
    """Random-intercept model, non-centered:

        mu ~ N(0, 5);  log_tau ~ N(0, 1);  theta_raw_g ~ N(0, 1)
        y_gi ~ N(mu + tau * theta_raw_g, noise_scale),  tau = exp(log_tau)

    ``y (G, n)`` is the reference's for the same arguments: its two
    ``normal`` draws under ``split(PRNGKey(seed))``, scaled and shifted as
    two float32 roundings each (the reference runs these ops eagerly, so
    XLA fuses no multiply-add). ``truth`` holds mu, tau and the groups'
    means theta."""
    dev = resolve_device(device)
    f32 = np.float32
    key_theta, key_y = jax_random.split(jax_random.prng_key(seed))
    true_theta = f32(true_mu) + f32(true_tau) * jax_random.normal(key_theta, (num_groups,))
    y_np = true_theta[:, None] + f32(noise_scale) * jax_random.normal(
        key_y, (num_groups, obs_per_group))
    y = torch.from_numpy(y_np).to(dev)

    def log_prob(params):
        mu, log_tau, theta_raw = params["mu"], params["log_tau"], params["theta_raw"]
        theta = mu + torch.exp(log_tau) * theta_raw  # (G,)
        lp = Normal(0.0, 5.0).log_prob(mu)
        lp = lp + Normal(0.0, 1.0).log_prob(log_tau)
        lp = lp + Normal(0.0, 1.0).log_prob(theta_raw).sum()
        lp = lp + Normal(theta[:, None], noise_scale).log_prob(y).sum()
        return lp

    log_prob.graph_safe = True
    init = {
        "mu": torch.zeros((), device=dev),
        "log_tau": torch.zeros((), device=dev),
        "theta_raw": torch.zeros(num_groups, device=dev),
    }
    truth = {"mu": true_mu, "tau": true_tau, "theta": torch.from_numpy(true_theta).to(dev)}
    return HierarchicalSpec(log_prob=log_prob, initial_params=init, y=y, truth=truth)


def eight_schools(centered: bool = False, device=None) -> HierarchicalSpec:
    """The eight-schools meta-analysis; ``centered=True`` is the funnel."""
    dev = resolve_device(device)
    y = torch.tensor([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0], device=dev)
    sigma = torch.tensor([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0], device=dev)

    if centered:

        def log_prob(params):
            mu, log_tau, theta = params["mu"], params["log_tau"], params["theta"]
            tau = torch.exp(log_tau)
            lp = Normal(0.0, 10.0).log_prob(mu)
            lp = lp + Normal(0.0, 1.0).log_prob(log_tau)
            lp = lp + Normal(mu, tau).log_prob(theta).sum()
            lp = lp + Normal(theta, sigma).log_prob(y).sum()
            return lp

        log_prob.graph_safe = True  # tensor ops on tensors made above only
        init = {"mu": 0.0, "log_tau": 0.0, "theta": torch.zeros(8, device=dev)}
        return HierarchicalSpec(log_prob=log_prob, initial_params=init, y=y, truth={})

    def log_prob(params):
        mu, log_tau, theta_raw = params["mu"], params["log_tau"], params["theta_raw"]
        tau = torch.exp(log_tau)
        theta = mu + tau * theta_raw
        lp = Normal(0.0, 10.0).log_prob(mu)
        lp = lp + Normal(0.0, 1.0).log_prob(log_tau)
        lp = lp + Normal(0.0, 1.0).log_prob(theta_raw).sum()
        lp = lp + Normal(theta, sigma).log_prob(y).sum()
        return lp

    log_prob.graph_safe = True
    init = {"mu": 0.0, "log_tau": 0.0, "theta_raw": torch.zeros(8, device=dev)}
    return HierarchicalSpec(log_prob=log_prob, initial_params=init, y=y, truth={})
