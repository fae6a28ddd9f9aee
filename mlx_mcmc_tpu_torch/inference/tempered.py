"""Parallel tempering (replica exchange) over a temperature ladder.

Counterpart of ``mlx_mcmc_tpu/inference/tempered.py``: R replicas of each
chain target ``p(z)^beta_r`` on a ladder ``1 = beta_0 > ... > beta_{R-1} >
0``, each rung with its own adapted step size and mass, and deterministic
even-odd (DEO) swap rounds after every step carry hot replicas' mode
crossings down to the cold chain, whose draws are the result.

Layout: rungs are rows. The reference vmaps its kernel over the ladder; here
the ``(R, C)`` replica x chain block is one ``(R*C, D)`` row block, row
``r*C + c`` holding rung ``r`` of chain ``c``, so the transition evaluates
every rung in one batched value+grad call (one K1 launch per leapfrog at
glm100_fused's data) and replays the engine's CUDA graphs
(``inference/graphs.py``) as ``sample()`` does. The value+grad multiplies
value and gradient by each row's beta and keeps the base one's
``graph_safe``. Tunables are per row (``kernels/base.py``): each rung's
step size and mass, expanded from rungs to rows once per step.

Swaps re-evaluate nothing: a tempered ``log_prob`` and ``grad`` scale
linearly in beta, so the swapped state is a gather along the replica axis
rescaled by ``beta_self / beta_src``, as in the reference; a swap round
launches no value+grad. Gathers make fresh tensors, so the graphs' next
replay, which overwrites their outputs, leaves the swapped state alone.

Adaptation per rung: dual averaging on the rung's chain-pooled mean accept
and Welford over the rung's ``(C, D)`` positions, through
``kernels/adaptation.adaptation_update``, one rung after another (a Python
loop over the rungs).

Random streams, every draw a function of (seed, chain, replica, step)
alone, never of C or R: a step's momenta (or noise) and uniform tables come
from one ``ops/random.step_draws`` call over all rows, row ``(r, c)`` keyed
on the chain word ``c + (r << 24)`` (so at most 2^24 chains and 256 rungs);
the swap uniforms, one per (chain, pair, step), from ``ops/random``'s
``STREAM_SWAP`` at ``(seed, c, t)``, value ``i`` for the pair whose lower
rung is ``i``, as the reference keys them by ``fold_in(key, pair_lo)``
(one launch of the Philox kernel's raw words per step on the card).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.inference.api import MCMCResult, cached_runner, transformed
from mlx_mcmc_tpu_torch.inference.engine import (
    _NOISE_KERNELS,
    batched_density,
    default_target_accept,
    graphed_transition,
    jittered_starts,
    make_kernel,
)
from mlx_mcmc_tpu_torch.kernels.adaptation import (
    adaptation_init,
    adaptation_update,
    build_schedule,
)
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.kernels.integrators import sample_momentum
from mlx_mcmc_tpu_torch.ops.random import STREAM_SWAP, step_draws, stream_uniforms
from mlx_mcmc_tpu_torch.ops.ravel import ravel_params

# Row (r, c)'s chain word is c + (r << 24): Philox's 32-bit chain counter
# holds 2^24 chains and 2^8 rungs.
_REPLICA_SHIFT = 24
MAX_CHAINS = 1 << _REPLICA_SHIFT
MAX_REPLICAS = 1 << (32 - _REPLICA_SHIFT)
_KERNELS = ("hmc", "mala", "nuts", "metropolis")
_KERNEL_KWARGS = {"num_leapfrog_steps": 10, "max_tree_depth": 10, "static_schedule": False,
                  "value_and_grad_fn": None}


def geometric_ladder(num_replicas: int, beta_min: float = 0.1) -> torch.Tensor:
    """Geometric inverse-temperature ladder 1 -> beta_min (cold first),
    float32 on the CPU."""
    if num_replicas < 2:
        return torch.ones((1,), dtype=torch.float32)
    r = torch.arange(num_replicas, dtype=torch.float32) / (num_replicas - 1)
    return torch.tensor(beta_min, dtype=torch.float32) ** r


def _partners(num: int, parity: int, device) -> torch.Tensor:
    """Each rung's partner in a DEO round (itself at an inactive end): even
    rounds pair boundaries 0, 2, 4, ..., odd rounds 1, 3, 5, ..."""
    idx = np.arange(num)
    if parity == 0:
        partner = np.where((idx ^ 1) < num, idx ^ 1, idx)
    else:
        raw = np.where(idx % 2 == 1, idx + 1, idx - 1)
        partner = np.where((idx == 0) | (raw >= num), idx, raw)
    return torch.as_tensor(partner, device=device)


def _swap_sources(betas: torch.Tensor, lp: torch.Tensor, parity: int, u: torch.Tensor):
    """One DEO swap round along the ladder for every chain.

    ``lp``: ``(R, C)`` *untempered* log densities at each replica's
    position; ``u``: ``(R, C)`` uniforms, row ``i`` the uniform of the pair
    whose lower rung is ``i``. Returns ``(src, alpha)``: gather indices
    ``(R, C)`` such that replica ``r`` adopts replica ``src[r]``'s state, and
    the per-boundary swap probabilities ``(R-1, C)`` (computed for inactive
    boundaries too; the caller masks by parity). Both members of a pair
    share the log-ratio ``(b_i - b_j)(lp_j - lp_i)`` and the uniform, so
    they decide alike and ``src`` is an involution.
    """
    num = betas.shape[0]
    idx = torch.arange(num, device=lp.device)
    partner = _partners(num, parity, lp.device)
    log_ratio = (betas - betas[partner])[:, None] * (lp[partner] - lp)
    log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
    log_u = torch.log(u[torch.minimum(idx, partner)])
    accept = (log_u < log_ratio) & (partner != idx)[:, None]
    src = torch.where(accept, partner[:, None], idx[:, None])
    return src, torch.exp(torch.clamp(log_ratio, max=0.0))[:-1]


def swap_round(state, betas: torch.Tensor, parity: int, u: torch.Tensor):
    """``(state, alpha (R-1, C))``: ``state`` (rows ``r*C + c``) after one
    DEO round, every field gathered into a fresh tensor along the replica
    axis and ``log_prob`` and ``grad`` (where the state has one) rescaled
    from the source rung's beta to the row's own."""
    num = betas.shape[0]
    num_chains = state.log_prob.shape[0] // num
    lp = state.log_prob.reshape(num, num_chains) / betas[:, None]
    src, alpha = _swap_sources(betas, lp, parity, u)
    rows = (src * num_chains + torch.arange(num_chains, device=src.device)).reshape(-1)
    scale = (betas[:, None] / betas[src]).reshape(-1)
    fields = {}
    for name, x in zip(state._fields, state):
        x = x.index_select(0, rows)
        if name == "log_prob":
            x = x * scale
        elif name == "grad":
            x = x * scale[:, None]
        fields[name] = x
    return type(state)(**fields), alpha


def chain_words(num_chains: int, num_replicas: int, device) -> torch.Tensor:
    """Each row's Philox chain word, ``c + (r << 24)`` at row ``r*C + c``."""
    c = torch.arange(num_chains, dtype=torch.int64, device=device)
    r = torch.arange(num_replicas, dtype=torch.int64, device=device)
    return (c[None, :] + (r[:, None] << _REPLICA_SHIFT)).reshape(-1)


def tempered_density(batched: Callable, beta_rows: torch.Tensor, with_grad: bool) -> Callable:
    """``batched`` (a value+grad, or a value) at each row's temperature:
    value (and gradient) times ``beta_rows`` ``(R*C,)``. Carries
    ``batched``'s ``graph_safe``."""
    if with_grad:
        def tempered(Z):
            value, grad = batched(Z)
            return value * beta_rows, grad * beta_rows[:, None]
    else:
        def tempered(Z):
            return batched(Z) * beta_rows

    tempered.graph_safe = graphs.captures(batched)
    return tempered


class LadderResult(NamedTuple):
    """A tempered run's raw output, on the device (:func:`build_tempered`)."""

    positions: torch.Tensor  # (C, S, D) cold draws
    info: TransitionInfo  # (C, S) fields, cold rows
    swap_acceptance: torch.Tensor  # (R-1,)
    step_sizes: torch.Tensor  # (R,) each rung's final step size
    inv_mass: torch.Tensor  # (R, D) each rung's final inverse mass
    state: Any  # every row's last state, after its swap round
    host_syncs: int
    graph_replays: int


@dataclass
class TemperedResult(MCMCResult):
    """Cold-chain posterior draws plus replica-exchange diagnostics.

    ``swap_acceptance``: (R-1,) mean swap probability per ladder boundary
    over the draws (boundary r is between replicas r and r+1).
    ``betas``: the inverse-temperature ladder used.
    ``replica_step_sizes``: (R,) adapted step size per rung.
    ``final_state``: the cold rung's last kernel state (the swapped one),
    on the device.
    """

    swap_acceptance: Optional[np.ndarray] = None
    betas: Optional[np.ndarray] = None
    replica_step_sizes: Optional[np.ndarray] = None
    final_state: Any = field(default=None, repr=False)


def build_tempered(flat_log_prob: Optional[Callable], dim: int, *, sampler: str = "tempered",
                   kernel: str, betas: tuple, num_warmup: int, num_samples: int, step_size: float,
                   adapt_step_size: bool, adapt_mass_matrix: bool, target_accept: float,
                   num_leapfrog_steps: int, max_tree_depth: int, static_schedule: bool,
                   value_and_grad_fn: Optional[Callable]):
    """Build ``run(seed, z0_batch (C, D), data) -> LadderResult`` for the
    ladder ``betas`` (a tuple of floats): every replica of chain ``c``
    starts at ``z0_batch[c]``; ``num_warmup`` adapted steps, then
    ``num_samples`` draws at the averaged tunables, a DEO swap round after
    every step (round ``t`` has parity ``t % 2``). The result holds the
    cold rung's ``positions`` ``(C, S, D)`` and ``info`` (``(C, S)``
    fields, the transitions' before the round), ``swap_acceptance`` (R-1,),
    the rungs' final ``step_sizes`` (R,) and ``inv_mass`` (R, D), the last
    ``state`` of every row, ``host_syncs`` and ``graph_replays``.

    On the card a value(+grad) that declares ``graph_safe`` runs through
    the engine's graphs (``engine.graphed_transition``), kept for the next
    call with the same device, chain count and ``data``. ``sampler`` names
    the sampler in the runner-cache key (``api.cached_runner``)."""
    num_replicas = len(betas)
    schedule = build_schedule(num_warmup, adapt_mass_matrix=adapt_mass_matrix)
    n_slots = 1 << (max_tree_depth - 1) if kernel == "nuts" else 1
    last_graphs = {}

    def run(seed: int, z0_batch: torch.Tensor, data=None) -> LadderResult:
        device = z0_batch.device
        num_chains = z0_batch.shape[0]
        betas_t = torch.tensor(betas, dtype=torch.float32, device=device)
        beta_rows = betas_t.repeat_interleave(num_chains)
        batched, _ = batched_density(kernel, flat_log_prob, value_and_grad_fn, data)
        batched = tempered_density(batched, beta_rows, kernel != "metropolis")
        init_fn, step_fn = make_kernel(kernel, batched, num_leapfrog_steps=num_leapfrog_steps,
                                       max_tree_depth=max_tree_depth,
                                       static_schedule=static_schedule)
        transition = graphed_transition(last_graphs, kernel, batched, step_fn, device,
                                        num_chains, data, max_tree_depth, static_schedule)
        if transition is not None:
            step_fn = transition.step
            replays0 = transition.replays
        words = chain_words(num_chains, num_replicas, device)
        chains = torch.arange(num_chains, device=device)
        states = init_fn(z0_batch.repeat(num_replicas, 1))
        adapts = [adaptation_init(dim, step_size, device=device) for _ in range(num_replicas)]
        host_syncs = 0

        def rung_tunables(log_step: str) -> Tunables:
            # each rung's tunables, expanded from rungs to rows
            if adapt_step_size:
                eps = torch.exp(torch.stack([getattr(a.da, log_step) for a in adapts]))
            else:
                eps = torch.full((num_replicas,), step_size, dtype=torch.float32, device=device)
            inv_mass = torch.stack([a.inv_mass_diag for a in adapts])
            return Tunables(eps, inv_mass)

        def rows(tun: Tunables) -> Tunables:
            return Tunables(tun.step_size.repeat_interleave(num_chains),
                            tun.inv_mass_diag.repeat_interleave(num_chains, dim=0))

        def one_step(states, t: int, tun: Tunables):
            x, U = step_draws(seed, words, t, dim, n_slots)
            if kernel not in _NOISE_KERNELS:
                x = sample_momentum(x, tun.inv_mass_diag)
            return step_fn(states, tun, x, U)

        def swaps(states, t: int):
            u = stream_uniforms(seed, chains, t, num_replicas, STREAM_SWAP).T
            return swap_round(states, betas_t, t % 2, u)

        for t in range(num_warmup):
            states, infos, syncs = one_step(states, t, rows(rung_tunables("log_step")))
            host_syncs += syncs
            accept = infos.accept_prob.reshape(num_replicas, num_chains).mean(dim=1)
            positions = states.position.reshape(num_replicas, num_chains, dim)
            adapts = [adaptation_update(a, accept[r], positions[r],
                                        bool(schedule.in_slow_window[t]),
                                        bool(schedule.window_end[t]), target_accept)
                      for r, a in enumerate(adapts)]
            states, _ = swaps(states, t)

        final = rung_tunables("log_step_avg")
        tun = rows(final)
        store = torch.empty((num_samples, num_chains, dim), dtype=torch.float32, device=device)
        alphas = torch.empty((num_samples, num_replicas - 1), dtype=torch.float32, device=device)
        info_store = None
        for j in range(num_samples):
            t = num_warmup + j
            states, infos, syncs = one_step(states, t, tun)
            host_syncs += syncs
            states, alpha = swaps(states, t)
            store[j] = states.position[:num_chains]
            alphas[j] = alpha.mean(dim=1)
            if info_store is None:
                info_store = TransitionInfo(*(
                    torch.empty((num_samples, num_chains), dtype=x.dtype, device=device)
                    for x in infos))
            for buf, x in zip(info_store, infos):
                buf[j] = x[:num_chains]
        if info_store is None:  # num_samples == 0
            info_store = TransitionInfo(*(torch.empty((0, num_chains), device=device)
                                          for _ in TransitionInfo._fields))

        # Per-boundary swap acceptance over the draws' rounds where it was
        # proposed: boundary r on rounds of parity r % 2.
        parities = torch.arange(num_warmup, num_warmup + num_samples, device=device) % 2
        active = parities[:, None] == (torch.arange(num_replicas - 1, device=device) % 2)
        swap_acc = torch.where(active, alphas, 0.0).sum(dim=0) / torch.clamp(
            active.sum(dim=0), min=1)
        return LadderResult(
            positions=store.transpose(0, 1), info=TransitionInfo(*(x.T for x in info_store)),
            swap_acceptance=swap_acc, step_sizes=final.step_size, inv_mass=final.inv_mass_diag,
            state=states, host_syncs=host_syncs,
            graph_replays=0 if transition is None else transition.replays - replays0)

    return run


def sample_tempered(
    log_prob_fn: Optional[Callable[..., torch.Tensor]],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 1,
    num_replicas: int = 8,
    betas=None,
    beta_min: float = 0.1,
    kernel: str = "hmc",
    seed: int = 0,
    step_size: float = 0.1,
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    jitter: float = 0.0,
    data=None,
    transforms: Optional[dict] = None,
    device=None,
    **kernel_kwargs,
) -> TemperedResult:
    """Sample a (possibly multimodal) posterior with parallel tempering.

    Runs ``num_chains`` independent replica ladders of ``num_replicas``
    temperatures each (a geometric ladder from 1 to ``beta_min``, or
    ``betas``: entries in (0, 1], starting at 1.0, strictly decreasing);
    returns the beta = 1 (cold) draws as an :class:`MCMCResult` with swap
    diagnostics. ``kernel`` is 'hmc', 'mala', 'nuts' or 'metropolis'
    ('chees' is refused: its trajectory adaptation is one global state).
    ``kernel_kwargs``: ``num_leapfrog_steps`` (hmc), ``max_tree_depth`` and
    ``static_schedule`` (nuts), ``value_and_grad_fn(Z, data)`` (a batched
    fused value+grad of the untempered density; ``log_prob_fn`` may then
    be None). The other options follow :func:`mlx_mcmc_tpu_torch.sample`;
    ``step_size`` is the float every rung starts from. ``device=None``
    means CUDA and raises without a GPU.

    Runners are cached as ``sample()``'s are (``api._RUNNER_CACHE``, keyed
    on the reference's items, the chain count, the device and ``data``):
    a second call with the same settings replays the graphs of the first.
    """
    if kernel == "chees":
        raise ValueError(
            "kernel='chees' is not supported under tempering (its trajectory "
            "adaptation is a single global state); use 'hmc', 'mala' or 'nuts'")
    if kernel not in _KERNELS:
        raise ValueError(f"Unknown kernel: {kernel!r}")
    unknown = sorted(set(kernel_kwargs) - set(_KERNEL_KWARGS))
    if unknown:
        raise ValueError(f"unsupported kernel kwarg(s) {unknown} for sample_tempered")
    if log_prob_fn is None and kernel_kwargs.get("value_and_grad_fn") is None:
        raise ValueError("pass log_prob_fn or value_and_grad_fn")
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    if betas is None:
        betas = geometric_ladder(num_replicas, beta_min)
    betas_np = np.asarray(torch.as_tensor(betas, dtype=torch.float32))
    if not (betas_np.ndim == 1 and betas_np.size >= 1 and betas_np[0] == 1.0
            and (betas_np > 0).all() and (np.diff(betas_np) < 0).all()):
        raise ValueError(
            f"betas must start at 1.0, be positive, and strictly decrease; got {betas_np}")
    num_replicas = int(betas_np.shape[0])
    if num_replicas > MAX_REPLICAS:
        raise ValueError(f"at most {MAX_REPLICAS} rungs (Philox chain words c + (r << 24)), "
                         f"got {num_replicas}")
    if num_chains >= MAX_CHAINS:
        raise ValueError(f"num_chains must be below 2**24 (Philox chain words c + (r << 24)), "
                         f"got {num_chains}")
    dev = resolve_device(device)
    if target_accept is None:
        target_accept = default_target_accept(kernel)
    options = dict(_KERNEL_KWARGS, **kernel_kwargs)
    settings = dict(sampler="tempered", kernel=kernel, betas=tuple(float(b) for b in betas_np),
                    num_warmup=int(num_warmup), num_samples=int(num_samples),
                    step_size=float(step_size), adapt_step_size=bool(adapt_step_size),
                    adapt_mass_matrix=bool(adapt_mass_matrix),
                    target_accept=float(target_accept), **options)
    maps = transformed(log_prob_fn, transforms, data)
    if maps[2] is not None:
        initial_params = maps[2](initial_params)
    entry = cached_runner(log_prob_fn, initial_params, data=data, transforms=transforms,
                          num_chains=num_chains, device=dev, settings=settings, maps=maps,
                          build=build_tempered)
    z0, _ = ravel_params(initial_params, device=dev)
    z0_batch = z0.expand(num_chains, z0.shape[0]).contiguous()
    if jitter > 0.0:
        z0_batch = jittered_starts(int(seed), z0_batch, jitter)
    out = entry["run"](int(seed), z0_batch, data)
    samples = entry["unravel"](out.positions)
    if entry["to_constrained"] is not None:
        samples = entry["to_constrained"](samples)
    cold = type(out.state)(*(x[:num_chains] for x in out.state))
    return TemperedResult(
        samples=samples,
        info=out.info,
        tunables=Tunables(out.step_sizes[0], out.inv_mass[0]),
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        host_syncs=out.host_syncs,
        graph_replays=out.graph_replays,
        swap_acceptance=out.swap_acceptance.cpu().numpy(),
        betas=betas_np.copy(),
        replica_step_sizes=out.step_sizes.cpu().numpy(),
        final_state=cold,
    )
