"""Sufficient-statistic collapse for the hierarchical normal and Poisson
group likelihoods.

Counterpart of ``mlx_mcmc_tpu/ops/suffstats.py``, with its names and
signatures. For the non-centered hierarchical normal (``models/
hierarchical.py``), ``y_gi ~ N(theta_g, sigma)`` with ``theta = mu + tau
theta_raw``, the data enter only through the group means ``ybar_g``:

    ll(theta) = -0.5/sigma^2 * sum_g n (theta_g - ybar_g)^2 + c0
    d ll / d theta_g = n (ybar_g - theta_g) / sigma^2

with ``c0 = -0.5/sigma^2 * sum_gi (y_gi - ybar_g)^2 - N log(sigma sqrt(2
pi))``. For the Poisson event rates (``models/poisson.py`` without
covariates), ``y_gi ~ Poisson(exp(theta_g))`` enters through the group sums
``S_g``:

    ll(theta) = sum_g [S_g theta_g - n exp(theta_g)] - sum_gi log(y_gi!)

Both collapses are exact (the same posterior), and one leapfrog's likelihood
work drops from O(chains * N) to O(chains * G) elementwise work with a
closed-form gradient. No kernel is warranted (the reference says the same of
its Pallas kernels): the sampler's own bookkeeping dominates.

The value+grads take the batched ``(C, D)`` positions directly and return
``(log_post (C,), grad (C, D))``; the reference's ``custom_vmap`` rules
batch the same arithmetic under its chain ``vmap``. Flat layout:
``ravel_params`` sorts keys, so ``z = [log_tau, mu, theta_raw_0..G-1]``.
The data's scalars are Python floats and its vectors tensors on the
device, so a CUDA graph can capture a call (``graph_safe``): nothing is
made from host data inside one. Row sums go through ``ops.math.row_sum``,
so a chain's numbers do not depend on how many chains run beside it.
"""

from __future__ import annotations

import functools
import math

import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.ops.math import row_sum

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def prepare_hier_normal_data(y, noise_scale: float = 1.0, device=None) -> dict:
    """Collapse a ``(num_groups, obs_per_group)`` observation matrix to its
    sufficient statistics for :func:`make_hier_normal_vag`: ``ybar (G,)``
    float32 on the device, and ``n_per_group``, ``c0`` and
    ``inv_noise_var`` as floats. ``ybar`` and the residual sum of squares
    are float32 reductions, as the reference's; their order differs from
    XLA's, so ``ybar`` agrees with the reference's to float32 rounding."""
    dev = resolve_device(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    num_groups, obs_per_group = y.shape
    ybar = y.mean(dim=1)
    rss = float(((y - ybar[:, None]) ** 2).sum())
    inv_var = 1.0 / (noise_scale * noise_scale)
    c0 = -0.5 * inv_var * rss - num_groups * obs_per_group * math.log(
        noise_scale * math.sqrt(2.0 * math.pi))
    return {
        "ybar": ybar.contiguous(),
        "n_per_group": float(obs_per_group),
        "c0": c0,
        "inv_noise_var": inv_var,
    }


def _noncentered(Z: torch.Tensor):
    """``(log_tau, mu, theta_raw, tau, theta)`` of positions ``Z (C, 2 +
    G)``."""
    log_tau, mu, theta_raw = Z[:, 0], Z[:, 1], Z[:, 2:]
    tau = torch.exp(log_tau)
    return log_tau, mu, theta_raw, tau, mu[:, None] + tau[:, None] * theta_raw


def _posterior(ll, r, theta_raw, tau, log_tau, mu, inv_mu_var, inv_lt_var):
    """The priors (mu ~ N(0, 1/sqrt(inv_mu_var)), log_tau ~ N(0,
    1/sqrt(inv_lt_var)), theta_raw ~ N(0, 1), normalizers excluded) added to
    the likelihood ``ll (C,)``, and the chain rule of ``r = d ll / d theta``
    through ``theta = mu + tau theta_raw``."""
    lp = (
        ll
        - 0.5 * inv_mu_var * mu * mu
        - 0.5 * inv_lt_var * log_tau * log_tau
        - 0.5 * row_sum(theta_raw * theta_raw)
    )
    grad = torch.cat(
        [
            (tau * row_sum(r * theta_raw) - inv_lt_var * log_tau)[:, None],
            (row_sum(r) - inv_mu_var * mu)[:, None],
            tau[:, None] * r - theta_raw,
        ],
        dim=1,
    )
    return lp, grad


def _prior_constants(prior_mu_scale: float, prior_log_tau_scale: float):
    inv_mu_var = 1.0 / (prior_mu_scale * prior_mu_scale)
    inv_lt_var = 1.0 / (prior_log_tau_scale * prior_log_tau_scale)
    log_norm = -math.log(prior_mu_scale) - math.log(prior_log_tau_scale)
    return inv_mu_var, inv_lt_var, log_norm


def make_hier_normal_vag(prior_mu_scale: float = 5.0, prior_log_tau_scale: float = 1.0):
    """``vag(Z (C, 2 + G), data) -> (log_post (C,), grad (C, 2 + G))`` of the
    non-centered hierarchical normal (priors mu ~ N(0, prior_mu_scale),
    log_tau ~ N(0, prior_log_tau_scale), theta_raw ~ N(0, 1)) over
    :func:`prepare_hier_normal_data`'s statistics. Closed-form gradient:
    with ``r_g = n (ybar_g - theta_g) / sigma^2``, ``d/dmu = sum r``,
    ``d/dlog_tau = tau sum(r theta_raw)``, ``d/dtheta_raw = tau r``."""
    inv_mu_var, inv_lt_var, log_norm = _prior_constants(prior_mu_scale, prior_log_tau_scale)

    def vag(Z: torch.Tensor, data: dict):
        log_tau, mu, theta_raw, tau, theta = _noncentered(Z)
        scale = data["n_per_group"] * data["inv_noise_var"]
        resid = data["ybar"] - theta  # (C, G), of the posterior's scale
        const = data["c0"] + log_norm - Z.shape[1] * _HALF_LOG_2PI
        ll = const - 0.5 * scale * row_sum(resid * resid)
        return _posterior(ll, scale * resid, theta_raw, tau, log_tau, mu,
                          inv_mu_var, inv_lt_var)

    vag.graph_safe = True  # see inference/graphs.py
    return vag


def make_hier_normal_model(prior_mu_scale: float = 5.0, prior_log_tau_scale: float = 1.0):
    """``(log_prob(params, data), vag)`` of the sufficient-statistic model,
    bound to the same prior scales, so the density and gradient halves
    cannot diverge."""
    log_prob = functools.partial(
        hier_suffstat_log_prob,
        prior_mu_scale=prior_mu_scale,
        prior_log_tau_scale=prior_log_tau_scale,
    )
    log_prob.graph_safe = True
    return log_prob, make_hier_normal_vag(prior_mu_scale, prior_log_tau_scale)


def prepare_poisson_rates_data(y, device=None) -> dict:
    """Collapse a ``(num_groups, obs_per_group)`` count matrix to the Poisson
    sufficient statistics for :func:`make_poisson_rates_model`: the group
    sums ``S (G,)`` (float32, on the device), ``n_per_group`` and ``c0 =
    -sum log(y!)`` (summed in float64) as floats."""
    dev = resolve_device(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    return {
        "S": y.sum(dim=1).contiguous(),
        "n_per_group": float(y.shape[1]),
        "c0": -float(torch.lgamma(y.double() + 1.0).sum()),
    }


def make_poisson_rates_model(prior_mu_scale: float = 5.0, prior_log_tau_scale: float = 1.0):
    """``(log_prob(params, data), vag)`` of the non-centered hierarchical
    Poisson event rates over :func:`prepare_poisson_rates_data`'s
    statistics, bound to one set of prior scales. Flat layout ``z =
    [log_tau, mu, theta_raw...]``; closed-form gradient with ``r_g = S_g - n
    exp(theta_g)``."""
    inv_mu_var, inv_lt_var, log_norm = _prior_constants(prior_mu_scale, prior_log_tau_scale)

    def vag(Z: torch.Tensor, data: dict):
        log_tau, mu, theta_raw, tau, theta = _noncentered(Z)
        n_lam = data["n_per_group"] * torch.exp(theta)
        const = data["c0"] + log_norm - Z.shape[1] * _HALF_LOG_2PI
        ll = const + row_sum(data["S"] * theta - n_lam)
        return _posterior(ll, data["S"] - n_lam, theta_raw, tau, log_tau, mu,
                          inv_mu_var, inv_lt_var)

    vag.graph_safe = True  # see inference/graphs.py

    def log_prob(params, data):
        theta_raw = params["theta_raw"]
        theta = params["mu"] + torch.exp(params["log_tau"]) * theta_raw
        ll = data["c0"] + (data["S"] * theta - data["n_per_group"] * torch.exp(theta)).sum()
        return (
            ll
            + log_norm
            - (2.0 + theta_raw.shape[0]) * _HALF_LOG_2PI
            - 0.5 * inv_mu_var * params["mu"] * params["mu"]
            - 0.5 * inv_lt_var * params["log_tau"] * params["log_tau"]
            - 0.5 * (theta_raw * theta_raw).sum()
        )

    log_prob.graph_safe = True
    return log_prob, vag


def hier_suffstat_log_prob(
    params: dict,
    data: dict,
    *,
    prior_mu_scale: float = 5.0,
    prior_log_tau_scale: float = 1.0,
) -> torch.Tensor:
    """Dict-level log-posterior over the sufficient statistics, the value
    twin of :func:`make_hier_normal_vag`. Its prior scales must be the
    vag's (bind them with ``functools.partial``, or use
    :func:`make_hier_normal_model`)."""
    mu, log_tau, theta_raw = params["mu"], params["log_tau"], params["theta_raw"]
    theta = mu + torch.exp(log_tau) * theta_raw
    resid = data["ybar"] - theta
    ll = data["c0"] - 0.5 * data["n_per_group"] * data["inv_noise_var"] * (resid * resid).sum()
    return (
        ll
        - math.log(prior_mu_scale)
        - math.log(prior_log_tau_scale)
        - (2.0 + theta_raw.shape[0]) * _HALF_LOG_2PI
        - 0.5 * (mu * mu) / (prior_mu_scale * prior_mu_scale)
        - 0.5 * (log_tau * log_tau) / (prior_log_tau_scale * prior_log_tau_scale)
        - 0.5 * (theta_raw * theta_raw).sum()
    )


hier_suffstat_log_prob.graph_safe = True
