"""Model comparison: WAIC and PSIS-LOO cross-validation.

Counterpart of ``mlx_mcmc_tpu/diagnostics/model_comparison.py`` (the
port's own copy; it imports nothing of the reference package), the
standard Bayesian-workflow model-selection estimators (Vehtari, Gelman &
Gabry 2017):

- :func:`pointwise_log_likelihood`: the per-observation log-likelihood at
  every (chain, draw), one ``torch.func.vmap`` over the flattened
  (chains x draws) on the draws' device, fetched once as numpy;
- :func:`waic`: elpd_waic = sum_n [log mean_s p(y_n|theta_s) -
  Var_s log p(y_n|theta_s)];
- :func:`psis_loo`: Pareto-smoothed importance-sampling leave-one-out, the
  largest 20% of the ratios 1/p(y_n|theta_s) smoothed by a fitted
  generalized Pareto distribution, with per-observation shape-k
  diagnostics;
- :func:`compare`: models ranked by elpd with pairwise standard errors.

Everything but :func:`pointwise_log_likelihood` is numpy on the host, the
reference's code line for line.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device

__all__ = [
    "pointwise_log_likelihood",
    "waic",
    "psis_loo",
    "compare",
]


def pointwise_log_likelihood(
    log_lik_fn: Callable[..., Any],
    samples: Dict[str, Any],
    data=None,
    device=None,
) -> np.ndarray:
    """Per-observation log-likelihood at every posterior draw.

    Args:
        log_lik_fn: ``params -> (N,) per-observation log-likelihoods``
            (``(params, data)`` when ``data`` is given): the likelihood
            part of the model's ``log_prob`` without its sum.
        samples: dict of (chains, draws, *event) draws
            (``MCMCResult.samples``), moved to ``device`` (None means CUDA
            and raises without a GPU).

    Returns:
        (chains, draws, N) numpy array: one ``torch.func.vmap`` over the
        flattened (chains x draws) on the device, fetched once.
    """
    dev = resolve_device(device)
    samples = {k: torch.as_tensor(v, device=dev) for k, v in samples.items()}
    num_chains, num_draws = next(iter(samples.values())).shape[:2]
    flat = {k: v.reshape((num_chains * num_draws,) + tuple(v.shape[2:]))
            for k, v in samples.items()}
    if data is not None:
        def fn(p):
            return log_lik_fn(p, data)
    else:
        fn = log_lik_fn
    with torch.no_grad():
        out = torch.func.vmap(fn)(flat)
    return out.reshape(num_chains, num_draws, -1).cpu().numpy()


def _logmeanexp(a: np.ndarray, axis=0) -> np.ndarray:
    m = np.max(a, axis=axis, keepdims=True)
    out = m.squeeze(axis) + np.log(
        np.mean(np.exp(a - m), axis=axis)
    )
    return out


def waic(log_lik: np.ndarray) -> Dict[str, float]:
    """WAIC from a (chains, draws, N) or (draws, N) pointwise log-lik array.

    Returns ``elpd_waic``, its standard error ``se``, the effective number
    of parameters ``p_waic``, and the deviance-scale ``waic = -2 elpd``.
    """
    ll = np.asarray(log_lik, np.float64)
    if ll.ndim == 3:
        ll = ll.reshape(-1, ll.shape[-1])
    lpd_i = _logmeanexp(ll, axis=0)  # (N,)
    p_i = np.var(ll, axis=0, ddof=1)  # (N,)
    elpd_i = lpd_i - p_i
    n = elpd_i.shape[0]
    return {
        "elpd_waic": float(np.sum(elpd_i)),
        "p_waic": float(np.sum(p_i)),
        "waic": float(-2.0 * np.sum(elpd_i)),
        "se": float(np.sqrt(n * np.var(elpd_i, ddof=1))),
        "pointwise": elpd_i,
    }


def _gpd_fit(x: np.ndarray) -> tuple[float, float]:
    """Generalized-Pareto (k, sigma) fit to exceedances ``x`` > 0 via the
    Zhang & Stephens (2009) quasi-posterior-mean estimator (the arviz/loo
    standard — robust without optimization)."""
    x = np.sort(x)
    n = x.shape[0]
    prior_bs = 3.0
    m = 30 + int(np.floor(np.sqrt(n)))
    bs = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    bs = bs / (prior_bs * x[int(np.floor(n / 4 + 0.5)) - 1]) + 1.0 / x[-1]
    ks = -bs[:, None] * x[None, :]
    ks = np.mean(np.log1p(ks), axis=1)  # (m,)
    L = n * (np.log(-bs / ks) - ks - 1.0)
    w = 1.0 / np.sum(np.exp(L[None, :] - L[:, None]), axis=1)
    b = np.sum(bs * w)
    k = float(np.mean(np.log1p(-b * x)))
    sigma = float(-k / b)
    # weak prior regularization toward 0.5 (Vehtari et al. 2017, app. C)
    k = k * n / (n + 10.0) + 0.5 * 10.0 / (n + 10.0)
    return k, sigma


def _gpd_quantiles(p: np.ndarray, k: float, sigma: float) -> np.ndarray:
    if abs(k) < 1e-12:
        return -sigma * np.log1p(-p)
    return sigma * np.expm1(-k * np.log1p(-p)) / k


def psis_loo(log_lik: np.ndarray) -> Dict[str, Any]:
    """PSIS-LOO from a (chains, draws, N) or (draws, N) pointwise log-lik.

    Returns ``elpd_loo``, ``se``, ``p_loo``, and per-observation Pareto
    shape diagnostics ``pareto_k`` (k > 0.7 flags unreliable observations,
    same thresholds as arviz/loo).
    """
    ll = np.asarray(log_lik, np.float64)
    if ll.ndim == 3:
        ll = ll.reshape(-1, ll.shape[-1])
    S, N = ll.shape
    lw = -ll  # log importance ratios for leave-one-out
    lw = lw - np.max(lw, axis=0, keepdims=True)

    n_tail = max(int(np.ceil(min(0.2 * S, 3.0 * np.sqrt(S)))), 5)
    if S <= n_tail:
        raise ValueError(
            f"need more posterior draws for PSIS: got S={S} total draws, "
            f"but the Pareto tail fit needs more than n_tail={n_tail}"
        )
    elpd_i = np.empty(N)
    ks = np.empty(N)
    for i in range(N):
        lw_i = lw[:, i].copy()
        order = np.argsort(lw_i)
        tail_idx = order[-n_tail:]
        cutoff = lw_i[order[-n_tail - 1]]
        exceed = np.exp(lw_i[tail_idx]) - np.exp(cutoff)
        if np.all(exceed <= 0) or np.ptp(exceed) <= 0:
            ks[i] = -np.inf
        else:
            k, sigma = _gpd_fit(exceed[exceed > 0])
            ks[i] = k
            if np.isfinite(k):
                # replace tail weights by expected GPD order statistics
                p = (np.arange(1, n_tail + 1) - 0.5) / n_tail
                smoothed = np.log(
                    _gpd_quantiles(p, k, sigma) + np.exp(cutoff)
                )
                lw_i[tail_idx[np.argsort(lw_i[tail_idx])]] = smoothed
        lw_i = np.minimum(lw_i, 0.0)  # truncate at max weight 1 (pre-norm)
        lw_i = lw_i - _logmeanexp(lw_i, axis=0) - np.log(S)
        elpd_i[i] = _logmeanexp(lw_i + ll[:, i] + np.log(S), axis=0)
    lpd_i = _logmeanexp(ll, axis=0)
    return {
        "elpd_loo": float(np.sum(elpd_i)),
        "p_loo": float(np.sum(lpd_i - elpd_i)),
        "se": float(np.sqrt(N * np.var(elpd_i, ddof=1))),
        "pareto_k": ks,
        "pointwise": elpd_i,
    }


def compare(
    model_log_liks: Dict[str, np.ndarray], method: str = "loo"
) -> Dict[str, Dict[str, float]]:
    """Rank models by elpd (higher is better) with pairwise difference SEs.

    Args:
        model_log_liks: name -> (chains, draws, N) pointwise log-lik arrays
            (all over the SAME observations).
        method: 'loo' (PSIS-LOO) or 'waic'.

    Returns:
        name -> {elpd, se, p_eff, rank, elpd_diff, diff_se} ordered best
        first; ``elpd_diff``/``diff_se`` are relative to the best model
        (paired over observations, as in arviz.compare).
    """
    est = psis_loo if method == "loo" else waic
    key = "elpd_loo" if method == "loo" else "elpd_waic"
    p_key = "p_loo" if method == "loo" else "p_waic"
    results = {name: est(ll) for name, ll in model_log_liks.items()}
    ranked = sorted(results, key=lambda n: -results[n][key])
    best_pw = results[ranked[0]]["pointwise"]
    out: Dict[str, Dict[str, float]] = {}
    for rank, name in enumerate(ranked):
        r = results[name]
        diff_pw = best_pw - r["pointwise"]
        n = diff_pw.shape[0]
        out[name] = {
            "elpd": r[key],
            "se": r["se"],
            "p_eff": r[p_key],
            "rank": rank,
            "elpd_diff": float(np.sum(diff_pw)),
            "diff_se": float(np.sqrt(n * np.var(diff_pw, ddof=1))),
        }
    return out
