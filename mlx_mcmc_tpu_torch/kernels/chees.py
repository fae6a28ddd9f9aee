"""ChEES-HMC: jittered-trajectory HMC with cross-chain trajectory adaptation.

Counterpart of ``mlx_mcmc_tpu/kernels/chees.py:59-209`` (Hoffman, Radul &
Sountsov 2021): every chain runs the same number of leapfrogs in a
transition, ``clip(ceil(u * exp(log_tau) / eps), 1, max_leapfrog_steps)``
with ``u`` the Halton fraction of the global step index, and warmup tunes
``log_tau`` by Adam ascent on the ChEES criterion estimated across chains.

The count is data-dependent (it follows the adapted ``log_tau`` and step
size), so the transition takes it from its caller as a host int: the
engine computes it on the device (:func:`num_leapfrogs`) and reads it once
per warmup step, or once for all the steps of a sampling phase, whose
``tau`` and ``eps`` are frozen. The transition comes in three parts
(:func:`make_chees_parts`): ``start`` (the momentum's energy and the
integration carry), ``leapfrog`` (one leapfrog and the step count) and
``end`` (energy, accept, select, info); ``inference/graphs.GraphedTrajectory``
captures each as a CUDA graph and replays ``leapfrog`` ``n`` times. As in
the HMC step the randomness comes in as tensors: momenta ``r0`` ``(C, D)``
and ``U`` ``(C, 1, 4)`` uniforms whose ``U[:, 0, 0]`` is the accept
uniform.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
from mlx_mcmc_tpu_torch.kernels.integrators import IntegratorState, leapfrog, total_energy
from mlx_mcmc_tpu_torch.ops.math import row_sum

HALTON_BITS = 16


class ChEESInfo(NamedTuple):
    """``TransitionInfo``'s fields and the endpoint quantities of the ChEES
    gradient: the trajectory's end before the accept (``proposal_position``)
    and its velocity ``M^-1 r`` (``end_velocity``), both ``(C, D)``. The
    engine strips them to ``(C, 0)`` in the stored draws."""

    accept_prob: torch.Tensor
    is_accepted: torch.Tensor
    is_divergent: torch.Tensor
    energy: torch.Tensor
    log_prob: torch.Tensor
    num_integration_steps: torch.Tensor
    tree_depth: torch.Tensor
    step_size: torch.Tensor
    proposal_position: torch.Tensor
    end_velocity: torch.Tensor


def halton_sequence(t: int, bits: int = HALTON_BITS) -> float:
    """Base-2 radical inverse of ``t + 1`` over its low ``bits`` bits, in
    (0, 1): the shared trajectory jitter of global step ``t``. Every term is
    dyadic and the sum has at most 16 significant bits, so this float is
    the reference's float32 value exactly."""
    t = (int(t) + 1) & 0xFFFFFFFF
    return sum(((t >> b) & 1) * 0.5 ** (b + 1) for b in range(bits))


def halton_device(steps: torch.Tensor, bits: int = HALTON_BITS) -> torch.Tensor:
    """:func:`halton_sequence` of each global step index in ``steps``
    (int64), as float32 on ``steps``' device (exact, as on the host)."""
    t = (steps + 1) & 0xFFFFFFFF
    u = torch.zeros(steps.shape, dtype=torch.float32, device=steps.device)
    for b in range(bits):
        u = u + ((t >> b) & 1).to(torch.float32) * (0.5 ** (b + 1))
    return u


def num_leapfrogs(trajectory_length: torch.Tensor, step_size: torch.Tensor,
                  max_leapfrog_steps: int) -> torch.Tensor:
    """The reference's leapfrog count ``clip(int32(ceil(trajectory_length /
    step_size)), 1, max_leapfrog_steps)``, elementwise on the device.
    XLA's float-to-int conversion saturates and takes NaN to 0: the count is
    clipped in float, NaN counted as 0, before the conversion."""
    steps = torch.nan_to_num(torch.ceil(trajectory_length / step_size), nan=0.0)
    return torch.clamp(steps, 1, max_leapfrog_steps).to(torch.int32)


class ChEESFrame(NamedTuple):
    """What ``end`` reads of the transition's start."""

    state: HMCState
    energy0: torch.Tensor  # (C,)


class ChEESCarry(NamedTuple):
    z: torch.Tensor  # (C, D)
    r: torch.Tensor  # (C, D)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D)
    steps: torch.Tensor  # (C,) int32: leapfrogs taken


class ChEESParts(NamedTuple):
    start: Callable  # (state, tunables, r0) -> (frame, carry)
    leapfrog: Callable  # (carry, tunables) -> carry
    end: Callable  # (frame, carry, tunables, U) -> (state, info)


def make_chees_parts(value_and_grad: Callable[[torch.Tensor], tuple],
                     max_delta_energy: float = 1000.0) -> ChEESParts:
    """The transition's three parts over ``value_and_grad(Z (C, D)) ->
    (log_prob (C,), grad (C, D))``; none reads the host."""

    def start(state: HMCState, tunables: Tunables, r0: torch.Tensor):
        integ = IntegratorState(state.position, r0, state.log_prob, state.grad)
        energy0 = total_energy(integ, tunables.inv_mass_diag)
        steps = torch.zeros(state.log_prob.shape, dtype=torch.int32, device=r0.device)
        return ChEESFrame(state, energy0), ChEESCarry(*integ, steps)

    def one_leapfrog(carry: ChEESCarry, tunables: Tunables) -> ChEESCarry:
        integ = leapfrog(IntegratorState(*carry[:4]), tunables.step_size,
                         tunables.inv_mass_diag, value_and_grad)
        return ChEESCarry(*integ, carry.steps + 1)

    def end(frame: ChEESFrame, carry: ChEESCarry, tunables: Tunables, U: torch.Tensor):
        inv_mass = tunables.inv_mass_diag
        state = frame.state
        energy1 = total_energy(IntegratorState(*carry[:4]), inv_mass)
        delta = frame.energy0 - energy1
        delta = torch.where(torch.isnan(delta), -math.inf, delta)
        accept = torch.log(U[:, 0, 0]) < delta
        new_state = HMCState(
            position=torch.where(accept[:, None], carry.z, state.position),
            log_prob=torch.where(accept, carry.log_prob, state.log_prob),
            grad=torch.where(accept[:, None], carry.grad, state.grad),
        )
        num_chains = state.position.shape[0]
        info = ChEESInfo(
            accept_prob=torch.exp(torch.clamp(delta, max=0.0)),
            is_accepted=accept,
            is_divergent=-delta > max_delta_energy,
            energy=frame.energy0,
            log_prob=new_state.log_prob,
            num_integration_steps=carry.steps.clone(),
            tree_depth=torch.zeros_like(carry.steps),
            step_size=tunables.step_size.expand(num_chains),
            proposal_position=carry.z.clone(),
            end_velocity=inv_mass * carry.r,
        )
        return new_state, info

    return ChEESParts(start, one_leapfrog, end)


def make_chees_kernel(value_and_grad: Callable[[torch.Tensor], tuple],
                      max_leapfrog_steps: int = 1000, max_delta_energy: float = 1000.0):
    """Build ``(init_fn, step_fn)`` for ChEES-HMC. ``step_fn(state,
    tunables, r0, U, num_steps) -> (state, info, host_syncs)`` integrates
    ``num_steps`` (a host int in ``[1, max_leapfrog_steps]``, from
    :func:`num_leapfrogs`) leapfrogs for every chain; ``host_syncs`` is 0."""
    parts = make_chees_parts(value_and_grad, max_delta_energy)

    def init_fn(position: torch.Tensor) -> HMCState:
        log_prob, grad = value_and_grad(position)
        return HMCState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(state: HMCState, tunables: Tunables, r0: torch.Tensor, U: torch.Tensor,
                num_steps: int):
        if not 1 <= num_steps <= max_leapfrog_steps:
            raise ValueError(f"num_steps must be in [1, {max_leapfrog_steps}], got {num_steps}")
        frame, carry = parts.start(state, tunables, r0)
        for _ in range(num_steps):
            carry = parts.leapfrog(carry, tunables)
        new_state, info = parts.end(frame, carry, tunables, U)
        return new_state, info, 0

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Trajectory-length adaptation (Adam ascent on the ChEES criterion)
# ---------------------------------------------------------------------------


class TrajectoryAdaptState(NamedTuple):
    log_tau: torch.Tensor  # 0-d float32
    adam_m: torch.Tensor
    adam_v: torch.Tensor
    count: torch.Tensor


def trajectory_init(step_size, device=None) -> TrajectoryAdaptState:
    """One step's worth of trajectory: ``log_tau = log(step_size)``."""
    log_tau = torch.log(torch.as_tensor(step_size, dtype=torch.float32, device=device))
    zero = torch.zeros_like(log_tau)
    return TrajectoryAdaptState(log_tau=log_tau, adam_m=zero, adam_v=zero, count=zero)


def chees_gradient(prev_positions: torch.Tensor, infos: ChEESInfo, jitter,
                   pmean: Optional[Callable] = None) -> torch.Tensor:
    """This transition's estimate of d ChEES / d tau (the paper's eq. 14):
    per chain ``accept_prob * (|z' - m'|^2 - |z - m|^2) * <z' - m', v'>``,
    ``m`` and ``m'`` the chain means of the start and end positions, then
    the mean over chains, scaled by the Halton fraction ``jitter``.
    ``pmean`` pools the two chain means (in one call) and the per-chain
    mean across ranks where chains are sharded (the reference's
    ``kernels/chees.py:175-181``)."""
    prop = infos.proposal_position
    means = torch.stack([prev_positions.mean(0), prop.mean(0)])
    m_prev, m_prop = means if pmean is None else pmean(means)
    d_prev = prev_positions - m_prev
    d_prop = prop - m_prop
    dsq_prev = row_sum(d_prev * d_prev)
    dsq_prop = row_sum(d_prop * d_prop)
    proj = row_sum(d_prop * infos.end_velocity)
    grad = (infos.accept_prob * (dsq_prop - dsq_prev) * proj).mean()
    return (grad if pmean is None else pmean(grad)) * jitter


def trajectory_update(
    state: TrajectoryAdaptState,
    grad: torch.Tensor,
    step_size: torch.Tensor,
    max_leapfrog_steps: int = 1000,
    learning_rate: float = 0.025,
    beta1: float = 0.9,
    beta2: float = 0.999,
) -> TrajectoryAdaptState:
    """One Adam ascent step on ``log_tau`` (bias-corrected), the gradient
    taken through the chain rule and clipped to +-1e6, the result clipped
    to ``[log(eps / 2), log(eps * max_leapfrog_steps)]``."""
    count = state.count + 1.0
    g = torch.clamp(grad * torch.exp(state.log_tau), -1e6, 1e6)
    m = beta1 * state.adam_m + (1 - beta1) * g
    v = beta2 * state.adam_v + (1 - beta2) * g * g
    m_hat = m / (1 - torch.pow(beta1, count))
    v_hat = v / (1 - torch.pow(beta2, count))
    log_tau = state.log_tau + learning_rate * m_hat / (torch.sqrt(v_hat) + 1e-8)
    log_tau = torch.minimum(torch.maximum(log_tau, torch.log(step_size * 0.5)),
                            torch.log(step_size * max_leapfrog_steps))
    return TrajectoryAdaptState(log_tau, m, v, count)
