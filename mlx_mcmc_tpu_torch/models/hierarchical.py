"""Eight schools, centered (the funnel) and non-centered.

Counterpart of ``eight_schools`` in ``mlx_mcmc_tpu/models/hierarchical.py``.
The centered form is the divergence stress benchmark: tau's scale sets the
width of theta's posterior, so the geometry is a funnel.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.distributions import Normal


class HierarchicalSpec(NamedTuple):
    log_prob: Callable
    initial_params: dict
    y: torch.Tensor
    truth: dict


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

    init = {"mu": 0.0, "log_tau": 0.0, "theta_raw": torch.zeros(8, device=dev)}
    return HierarchicalSpec(log_prob=log_prob, initial_params=init, y=y, truth={})
