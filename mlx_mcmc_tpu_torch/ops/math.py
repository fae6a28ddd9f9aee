"""Numerics helpers: NaN-safe support masking, Welford streaming moments
and the Adam step.

Counterpart of ``mlx_mcmc_tpu/ops/math.py``. The Welford accumulators drive
the diagonal mass-matrix adaptation; ``welford_batch_update`` pools all
chains in one vectorized update (Chan et al.'s parallel merge), and
``welford_psum_merge`` pools the accumulators of several ranks.
:func:`adam_update` is the one Adam of the package (the MAP init and the
ADVI fits; the reference takes ``optax.adam`` for both).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


_INVARIANT_ROWS = 16


def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``x.sum(-1)`` for chain-major ``x`` (chains first), summed in an order
    that does not depend on how many chains ``x`` holds, so a chain's
    result is the same bits in a batch of any size. PyTorch's CUDA
    reduction picks how many lanes share one output from the number of
    outputs while that is below 16 (``set_block_dimension`` in ATen's
    ``Reduce.cuh``), and from the row length alone from 16 up; batches of
    fewer than 16 chains are padded with zero rows to 16."""
    c = x.shape[0]
    if c >= _INVARIANT_ROWS or x.device.type != "cuda":
        return x.sum(-1)
    pad = x.new_zeros((_INVARIANT_ROWS - c,) + tuple(x.shape[1:]))
    return torch.cat([x, pad]).sum(-1)[:c]


def safe_where_log_prob(
    in_support: torch.Tensor,
    value,
    safe_value,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """Evaluate ``log_prob_fn`` only on in-support values, ``-inf`` elsewhere.

    Out-of-support inputs are replaced by a safe dummy before the call, so
    gradients at the boundary are zero instead of NaN (the double-where
    trick).
    """
    value = torch.as_tensor(value)
    safe = torch.where(in_support, value, torch.as_tensor(safe_value, dtype=value.dtype))
    return torch.where(in_support, log_prob_fn(safe), -math.inf)


class WelfordState(NamedTuple):
    """Streaming mean/variance over position vectors; ``count`` is a float
    0-d tensor, ``mean`` and ``m2`` have the observed vector's shape."""

    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim: int, dtype=torch.float32, device=None) -> WelfordState:
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros((dim,), dtype=dtype, device=device),
        m2=torch.zeros((dim,), dtype=dtype, device=device),
    )


def welford_update(state: WelfordState, x: torch.Tensor) -> WelfordState:
    """Add one observation ``x`` (shape ``(dim,)``)."""
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count
    m2 = state.m2 + delta * (x - mean)
    return WelfordState(count, mean, m2)


def welford_batch_update(state: WelfordState, xs: torch.Tensor) -> WelfordState:
    """Merge a batch of observations ``xs`` (shape ``(batch, dim)``)."""
    b = float(xs.shape[0])
    batch_mean = xs.mean(dim=0)
    batch_m2 = ((xs - batch_mean) ** 2).sum(dim=0)
    count = state.count + b
    safe = torch.clamp(count, min=1.0)
    delta = batch_mean - state.mean
    mean = state.mean + delta * (b / safe)
    m2 = state.m2 + batch_m2 + delta**2 * (state.count * b / safe)
    return WelfordState(count, mean, m2)


def welford_merge(a: WelfordState, b: WelfordState) -> WelfordState:
    """Merge two accumulators."""
    count = a.count + b.count
    delta = b.mean - a.mean
    safe = torch.clamp(count, min=1.0)
    mean = a.mean + delta * (b.count / safe)
    m2 = a.m2 + b.m2 + delta**2 * (a.count * b.count / safe)
    return WelfordState(count, mean, m2)


def welford_psum_merge(state: WelfordState, psum: Callable) -> WelfordState:
    """Pool every rank's accumulator exactly, ``psum`` summing a tensor
    over the ranks: the reference's ``_welford_pmean_reduce``
    (``mlx_mcmc_tpu/inference/engine.py:138-148``), in its formula and
    order. The count and the count-weighted means go in one sum."""
    sums = psum(torch.cat([state.count.reshape(1), state.mean * state.count]))
    total = sums[0]
    mean = sums[1:] / torch.clamp(total, min=1.0)
    m2 = psum(state.m2 + state.count * (state.mean - mean) ** 2)
    return WelfordState(total, mean, m2)


def welford_finalize(state: WelfordState, regularize: bool = True) -> torch.Tensor:
    """Sample variance, shrunk toward unit scale as Stan does:
    ``n/(n+5) * var + 1e-3 * 5/(n+5)``."""
    n = state.count
    var = state.m2 / torch.clamp(n - 1.0, min=1.0)
    if regularize:
        w = n / (n + 5.0)
        var = w * var + 1e-3 * (1.0 - w)
    return torch.where(n > 1.0, var, torch.ones_like(var))


_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def adam_update(params, grads, m, v, count: int, learning_rate: float):
    """One Adam step on tuples of tensors, as ``optax.adam`` computes it:
    bias-corrected moments, ``count`` the step's 1-based index. A
    non-finite gradient entry counts as 0. Returns ``(params, m, v)``;
    reads nothing on the host."""
    new_p, new_m, new_v = [], [], []
    for p, g, m_i, v_i in zip(params, grads, m, v):
        g = torch.where(torch.isfinite(g), g, 0.0)
        m_i = (1 - _ADAM_B1) * g + _ADAM_B1 * m_i
        v_i = (1 - _ADAM_B2) * g * g + _ADAM_B2 * v_i
        m_hat = m_i / (1 - _ADAM_B1**count)
        v_hat = v_i / (1 - _ADAM_B2**count)
        new_p.append(p + -learning_rate * (m_hat / (torch.sqrt(v_hat) + _ADAM_EPS)))
        new_m.append(m_i)
        new_v.append(v_i)
    return tuple(new_p), tuple(new_m), tuple(new_v)
