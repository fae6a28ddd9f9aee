"""Split R-hat, effective sample size and summaries on host numpy arrays.

The port's own copy of what ``MCMCResult`` needs from
``mlx_mcmc_tpu/diagnostics/stats.py`` (numpy path only; the reference's
OpenMP extension is not used). Inputs are ``(chains, draws, ...)``; trailing
axes are independent parameters.
"""

from __future__ import annotations

import numpy as np


def _split_chains(x: np.ndarray) -> np.ndarray:
    """(chains, draws, ...) -> (2*chains, draws//2, ...), dropping an odd draw."""
    half = x.shape[1] // 2
    x = x[:, : 2 * half]
    return np.concatenate([x[:, :half], x[:, half:]], axis=0)


def potential_scale_reduction(x: np.ndarray, split: bool = True) -> np.ndarray:
    """Split R-hat. ``x`` is (chains, draws, ...); returns shape ``(...)``."""
    x = np.asarray(x, np.float64)
    if split:
        x = _split_chains(x)
    n = x.shape[1]
    if n < 2:
        return np.full(x.shape[2:], np.nan)
    chain_means = x.mean(axis=1)
    chain_vars = x.var(axis=1, ddof=1)
    within = chain_vars.mean(axis=0)
    between = n * chain_means.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * within + between / n
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / within)


def effective_sample_size(x: np.ndarray) -> np.ndarray:
    """Combined-chain ESS: FFT autocovariance + Geyer initial monotone
    positive sequence. ``x`` is (chains, draws, ...); returns ``(...)``."""
    x = np.asarray(x, np.float64)
    m, n = x.shape[0], x.shape[1]
    if n < 4:
        return np.full(x.shape[2:], np.nan)

    centered = x - x.mean(axis=1, keepdims=True)
    pad = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(centered, n=pad, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=pad, axis=1)[:, :n].real / n

    chain_var = acov[:, 0] * n / (n - 1.0)  # unbiased lag-0
    mean_var = chain_var.mean(axis=0)  # W
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus = var_plus + x.mean(axis=1).var(axis=0, ddof=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (mean_var[None] - acov.mean(axis=0)) / var_plus[None]
    rho[0] = 1.0

    max_pairs = n // 2
    pair = rho[: 2 * max_pairs].reshape(max_pairs, 2, *rho.shape[1:]).sum(axis=1)
    keep = np.logical_and.accumulate(pair > 0, axis=0)
    pair = np.where(keep, pair, 0.0)
    pair = np.minimum.accumulate(pair, axis=0)
    pair = np.maximum(pair, 0.0)
    tau = -1.0 + 2.0 * pair.sum(axis=0)
    ess = m * n / np.maximum(tau, 1e-12)
    return np.minimum(ess, m * n * np.log10(np.maximum(m * n, 10.0)))


def summary_stats(x: np.ndarray, credible_interval: float = 0.95) -> dict:
    """Posterior summary of a (chains, draws) array: mean/std/median, the
    percentile-named interval keys ('2.5%'/'97.5%'), n_eff and r_hat."""
    x = np.asarray(x)
    flat = x.reshape(-1, *x.shape[2:])
    alpha = 1 - credible_interval
    lower_pct = 100 * alpha / 2
    upper_pct = 100 * (1 - alpha / 2)
    return {
        "mean": float(np.mean(flat)),
        "std": float(np.std(flat)),
        "median": float(np.median(flat)),
        f"{lower_pct:.1f}%": float(np.percentile(flat, lower_pct)),
        f"{upper_pct:.1f}%": float(np.percentile(flat, upper_pct)),
        "n_eff": float(effective_sample_size(x)),
        "r_hat": float(potential_scale_reduction(x)),
    }
