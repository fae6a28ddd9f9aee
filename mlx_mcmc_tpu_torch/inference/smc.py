"""Tempered sequential Monte Carlo (SMC sampler).

Counterpart of ``mlx_mcmc_tpu/inference/smc.py``: a particle population
anneals from ``q0 = N(z0, q0_scale^2 I)`` to the posterior ``p`` along
``pi_beta ∝ q0^(1-beta) p^beta``, beta from 0 to 1, reweighting,
resampling (systematic) and mutating (K random-walk Metropolis steps shaped
by the population's spread) at every stage, and estimates the evidence
``log Z`` as the sum of the stages' log mean incremental weights.

The reference runs its adaptive stage loop as one ``lax.while_loop``. Here
the host reads ``beta < 1`` once per stage (``SMCResult.host_syncs``);
inside a stage nothing is read: the next beta's 30-step bisection on the
ESS of the incremental weights, the resampling and the K mutation steps
are eager launches on the device, each over the whole ``(P, D)``
population (one batched log density per mutation,
``engine.make_batched_value``).

Random streams, each a function of the particle and a step index, never of
P: particle ``i``'s start is the engine's jittered start
(``engine.jittered_starts``: ``q0_scale`` times Philox normals at
``(seed, i, engine.JITTER_STEP)``); its mutation normals and accept uniform
at stage ``s``, mutation ``k`` come from one ``ops/random.step_draws`` call
at step ``s*K + k``; the stage's one resampling uniform from
``STREAM_RESAMPLE`` at ``(seed, 0, s)``. The reference splits one key per
stage.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.inference.api import transformed
from mlx_mcmc_tpu_torch.inference.engine import jittered_starts, make_batched_value
from mlx_mcmc_tpu_torch.ops.math import row_sum
from mlx_mcmc_tpu_torch.ops.random import STREAM_RESAMPLE, step_draws, stream_uniforms
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

_LOG_2PI = math.log(2.0 * math.pi)
_BISECTION_STEPS = 30


@dataclass
class SMCResult:
    """Final particle population + evidence estimate.

    ``particles``: dict name -> (num_particles, *event) equally weighted
    posterior draws, on the device. ``log_evidence``: the estimate of
    log ∫ p(z) dz relative to the normalized q0 (for a normalized
    ``log_prob``, the log marginal likelihood). ``final_beta`` < 1.0 means
    the ladder hit ``max_stages``. ``host_syncs``: the host's reads of the
    stage loop's condition, one per stage and one that ends the loop (none
    after ``max_stages``).
    """

    particles: Dict[str, Any]
    log_evidence: float
    num_stages: int
    final_accept_rate: float
    num_particles: int
    final_beta: float = 1.0
    host_syncs: int = 0
    _flat: torch.Tensor = field(repr=False, default=None)


def _systematic_resample(log_weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Systematic (low-variance) resampling from one uniform ``u`` (0-d):
    ancestor indices into the population (gather, don't recompute, the log
    densities)."""
    n = log_weights.shape[0]
    cum = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
    strata = (u + torch.arange(n, dtype=torch.float32, device=log_weights.device)) / n
    return torch.clamp(torch.searchsorted(cum, strata), 0, n - 1)


def _ess(delta: torch.Tensor, delta_lp: torch.Tensor) -> torch.Tensor:
    lw = delta * delta_lp
    w = torch.exp(lw - lw.max())
    return torch.square(w.sum()) / torch.square(w).sum()


def _next_beta(beta: torch.Tensor, delta_lp: torch.Tensor, target: float) -> torch.Tensor:
    """The next beta increment (0-d), on the device: the largest step whose
    incremental weights keep ESS >= ``target`` by a 30-step bisection, or
    the whole remaining step if it does; at least 1e-6."""
    lo = torch.zeros_like(beta)
    hi = 1.0 - beta
    for _ in range(_BISECTION_STEPS):
        mid = 0.5 * (lo + hi)
        ok = _ess(mid, delta_lp) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    full_ok = _ess(1.0 - beta, delta_lp) >= target
    delta = torch.where(full_ok, 1.0 - beta, lo)
    return torch.clamp(delta, min=1e-6)


def sample_smc(
    log_prob_fn: Callable[..., torch.Tensor],
    initial_params: Any,
    *,
    num_particles: int = 1024,
    num_mutations: int = 5,
    ess_target: float = 0.5,
    max_stages: int = 100,
    q0_scale: float = 1.0,
    seed: int = 0,
    data=None,
    transforms: Optional[dict] = None,
    device=None,
) -> SMCResult:
    """Run adaptive tempered SMC from ``N(z0, q0_scale^2 I)`` to the
    posterior.

    ``log_prob_fn``: a dict-of-params model (``(params, data)`` with
    ``data``). ``num_mutations``: Metropolis steps per stage.
    ``ess_target``: each next temperature keeps the incremental weights'
    ESS at this fraction of the population. ``max_stages``: a cap on the
    ladder's length (a ``RuntimeWarning`` if it stops the ladder below 1).
    ``q0_scale``: the sd of the Gaussian start around the (unconstrained)
    ``initial_params``. ``transforms``: anneal in unconstrained space,
    return constrained particles. ``device=None`` means CUDA and raises
    without a GPU.

    Returns an :class:`SMCResult` with equally weighted particles and the
    log-evidence estimate.
    """
    if not 0.0 < ess_target < 1.0:
        raise ValueError("ess_target must be in (0, 1)")
    dev = resolve_device(device)
    lp_fn, to_constrained, to_unconstrained = transformed(log_prob_fn, transforms, data)
    if to_unconstrained is not None:
        initial_params = to_unconstrained(initial_params)
    flat_log_prob, z0, unravel = make_flat_logprob(lp_fn, initial_params,
                                                   data_aware=data is not None, device=dev)
    dim = z0.shape[0]
    batch_lp = make_batched_value(flat_log_prob, data)
    ids = torch.arange(num_particles, device=dev)
    target = ess_target * num_particles

    def log_q0(z):
        return row_sum(-0.5 * ((z - z0) / q0_scale) ** 2 - math.log(q0_scale) - 0.5 * _LOG_2PI)

    def tempered(lp, lq, beta):
        return (1.0 - beta) * lq + beta * lp

    def mutate(stage, particles, lp, lq, beta):
        """K random-walk Metropolis steps at pi_beta, the proposal shaped by
        the population's per-dimension spread (2.38/sqrt(d) scaling)."""
        std = particles.std(dim=0, unbiased=False) + 1e-6
        scale = 2.38 / math.sqrt(dim) * std
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for k in range(num_mutations):
            noise, U = step_draws(int(seed), ids, stage * num_mutations + k, dim, 1)
            prop = particles + scale * noise
            lp_p = batch_lp(prop)
            lq_p = log_q0(prop)
            log_alpha = tempered(lp_p, lq_p, beta) - tempered(lp, lq, beta)
            log_alpha = torch.where(torch.isnan(log_alpha), -math.inf, log_alpha)
            accept = torch.log(U[:, 0, 0]) < log_alpha
            particles = torch.where(accept[:, None], prop, particles)
            lp = torch.where(accept, lp_p, lp)
            lq = torch.where(accept, lq_p, lq)
            acc = acc + accept.float().mean()
        return particles, lp, lq, acc / num_mutations

    with torch.no_grad():
        particles = jittered_starts(int(seed), z0.expand(num_particles, dim).contiguous(),
                                    q0_scale)
        lp = batch_lp(particles)
        lq = log_q0(particles)
        beta = torch.zeros((), dtype=torch.float32, device=dev)
        log_z = torch.zeros((), dtype=torch.float32, device=dev)
        acc = torch.ones((), dtype=torch.float32, device=dev)
        stage = host_syncs = 0
        while stage < max_stages:
            host_syncs += 1
            if not bool(beta < 1.0):
                break
            delta_lp = lp - lq
            delta = _next_beta(beta, delta_lp, target)
            lw = delta * delta_lp
            m = lw.max()
            log_z = log_z + m + torch.log(torch.mean(torch.exp(lw - m)))
            u = stream_uniforms(int(seed), ids[:1], stage, 1, STREAM_RESAMPLE)[0, 0]
            idx = _systematic_resample(lw, u)
            particles, lp, lq = particles[idx], lp[idx], lq[idx]
            beta = beta + delta
            particles, lp, lq, acc = mutate(stage, particles, lp, lq, beta)
            stage += 1
    out = unravel(particles)
    if to_constrained is not None:
        out = to_constrained(out)
    final_beta, log_evidence, accept_rate = (float(x) for x in torch.stack([beta, log_z, acc]))
    if final_beta < 1.0:
        warnings.warn(
            f"tempered SMC hit max_stages={max_stages} at beta={final_beta:.4f} < 1.0: "
            "particles target an intermediate tempered distribution, NOT the posterior. "
            "Raise max_stages or lower ess_target.",
            RuntimeWarning,
            stacklevel=2,
        )
    return SMCResult(
        particles=out,
        log_evidence=log_evidence,
        num_stages=stage,
        final_accept_rate=accept_rate,
        num_particles=num_particles,
        final_beta=final_beta,
        host_syncs=host_syncs,
        _flat=particles,
    )
