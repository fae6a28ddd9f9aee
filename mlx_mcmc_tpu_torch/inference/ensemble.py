"""Affine-invariant ensemble sampler (Goodman & Weare stretch move).

Counterpart of ``mlx_mcmc_tpu/inference/ensemble.py``: walkers are the
batch axis, updated in two fixed halves (emcee's complementary-halves
scheme), each half against the other, so every half-update is one batched
log density over ``(W/2, D)``. Stretch move: partner ``X_j`` from the other
half, scale ``z ~ g(z) ∝ 1/sqrt(z)`` on ``[1/a, a]``, proposal ``Y = X_j +
z (X_k - X_j)``, accepted with probability ``min(1, z^(D-1) p(Y)/p(X_k))``.
No tuning: the result reports ``a`` as its step size and a unit mass.

The steps run eagerly (one batched log density per half, no gradient:
``engine.make_batched_value``). Random streams: walker ``w``'s partner,
stretch and accept uniforms at step ``t`` are values 0-2 of Philox's
uniform stream at ``(seed, w, t)`` (one launch of the kernel's raw words
per step on the card), and its start is the engine's jittered start
(``engine.jittered_starts``), so a walker's draws do not depend on how
many walkers run; the reference splits one key per half and step.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.inference.api import MCMCResult, transformed
from mlx_mcmc_tpu_torch.inference.engine import jittered_starts, make_batched_value
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.ops.random import STREAM_UNIFORM, stream_uniforms
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob


def _half_update(active: torch.Tensor, active_lp: torch.Tensor, other: torch.Tensor, a: float,
                 batch_log_prob: Callable, partners: torch.Tensor, u_z: torch.Tensor,
                 u_accept: torch.Tensor):
    """Stretch-move update of one half-ensemble ``active (n, D)`` against
    ``other``, from explicit draws: ``partners`` (n,) indices into
    ``other``, ``u_z`` and ``u_accept`` (n,) uniforms. Returns ``(new,
    new_lp, accepted, accept_prob)``."""
    dim = active.shape[1]
    x_j = other[partners]
    # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a] via inverse-CDF: z = ((a-1)u + 1)² / a
    z = ((a - 1.0) * u_z + 1.0) ** 2 / a
    proposal = x_j + z[:, None] * (active - x_j)
    proposal_lp = batch_log_prob(proposal)
    log_accept = (dim - 1) * torch.log(z) + proposal_lp - active_lp
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    accepted = torch.log(u_accept) < log_accept
    new = torch.where(accepted[:, None], proposal, active)
    new_lp = torch.where(accepted, proposal_lp, active_lp)
    return new, new_lp, accepted, torch.exp(torch.clamp(log_accept, max=0.0))


def _partner_index(u: torch.Tensor, n: int) -> torch.Tensor:
    """A uniform index in ``[0, n)`` from a uniform in [0, 1)."""
    return torch.clamp((u * n).long(), max=n - 1)


def sample_ensemble(
    log_prob_fn: Callable[..., torch.Tensor],
    initial_params: Any,
    *,
    num_walkers: int = 64,
    num_samples: int = 1000,
    num_warmup: int = 500,
    thin: int = 1,
    a: float = 2.0,
    seed: int = 0,
    jitter: float = 0.1,
    data=None,
    transforms: Optional[dict] = None,
    device=None,
) -> MCMCResult:
    """Run the affine-invariant ensemble sampler.

    ``log_prob_fn``: a dict-of-params model (``(params, data)`` with
    ``data``), as for :func:`mlx_mcmc_tpu_torch.sample`. ``num_walkers``:
    even, at least 4, and best at least twice the dimension. ``a``: the
    stretch scale (> 1). ``jitter``: the sd of the Gaussian ball the
    walkers start in (nonzero by default: coincident walkers propose
    nothing). ``transforms``: sample in unconstrained space, return
    constrained draws. ``thin`` keeps every ``thin``-th step's walkers and
    that step's info. ``device=None`` means CUDA and raises without a GPU.

    Returns an :class:`MCMCResult` with walkers on the chains axis
    (``kernel='ensemble'``, step size ``a``, unit mass), so ``summary`` and
    ``diagnostics`` treat walkers as chains.
    """
    if num_walkers < 4 or num_walkers % 2 != 0:
        raise ValueError("num_walkers must be even and >= 4")
    if a <= 1.0:
        raise ValueError("stretch scale a must be > 1")
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    dev = resolve_device(device)
    lp_fn, to_constrained, to_unconstrained = transformed(log_prob_fn, transforms, data)
    if to_unconstrained is not None:
        initial_params = to_unconstrained(initial_params)
    flat_log_prob, z0, unravel = make_flat_logprob(lp_fn, initial_params,
                                                   data_aware=data is not None, device=dev)
    dim = z0.shape[0]
    half = num_walkers // 2
    batch_log_prob = make_batched_value(flat_log_prob, data)
    ids = torch.arange(num_walkers, device=dev)

    walkers = jittered_starts(int(seed), z0.expand(num_walkers, dim).contiguous(), jitter)
    lps = batch_log_prob(walkers)
    ones_i32 = torch.ones((num_walkers,), dtype=torch.int32, device=dev)
    step_size = torch.full((num_walkers,), a, dtype=torch.float32, device=dev)

    def one_step(walkers, lps, t: int):
        u = stream_uniforms(int(seed), ids, t, 3, STREAM_UNIFORM)
        first, second = walkers[:half], walkers[half:]
        first, lp_first, acc0, ap0 = _half_update(
            first, lps[:half], second, a, batch_log_prob, _partner_index(u[:half, 0], half),
            u[:half, 1], u[:half, 2])
        second, lp_second, acc1, ap1 = _half_update(
            second, lps[half:], first, a, batch_log_prob, _partner_index(u[half:, 0], half),
            u[half:, 1], u[half:, 2])
        walkers = torch.cat([first, second])
        lps = torch.cat([lp_first, lp_second])
        info = TransitionInfo(
            accept_prob=torch.cat([ap0, ap1]),
            is_accepted=torch.cat([acc0, acc1]),
            is_divergent=torch.zeros((num_walkers,), dtype=torch.bool, device=dev),
            energy=-lps,
            log_prob=lps,
            num_integration_steps=ones_i32,
            tree_depth=torch.zeros_like(ones_i32),
            step_size=step_size,
        )
        return walkers, lps, info

    with torch.no_grad():
        for t in range(num_warmup):
            walkers, lps, _ = one_step(walkers, lps, t)
        store = torch.empty((num_samples, num_walkers, dim), dtype=torch.float32, device=dev)
        info_store = TransitionInfo(*(
            torch.empty((num_samples, num_walkers), dtype=dtype, device=dev)
            for dtype in (torch.float32, torch.bool, torch.bool, torch.float32, torch.float32,
                          torch.int32, torch.int32, torch.float32)))
        for j in range(num_samples):
            t0 = num_warmup + j * thin
            for i in range(thin):
                walkers, lps, info = one_step(walkers, lps, t0 + i)
            store[j] = walkers
            for buf, x in zip(info_store, info):
                buf[j] = x
    samples = unravel(store.transpose(0, 1))
    if to_constrained is not None:
        samples = to_constrained(samples)
    return MCMCResult(
        samples=samples,
        info=TransitionInfo(*(x.T for x in info_store)),
        tunables=Tunables(step_size=torch.tensor(a, dtype=torch.float32, device=dev),
                          inv_mass_diag=torch.ones((dim,), dtype=torch.float32, device=dev)),
        num_chains=num_walkers,
        num_samples=num_samples,
        kernel="ensemble",
    )
