"""Multi-chain sampling engine: init -> step-size probe -> warmup -> draws.

Counterpart of ``build_sampler`` in ``mlx_mcmc_tpu/inference/engine.py``
(the NUTS subset). The reference's two ``lax.scan`` loops become Python
loops over batched ``(C, D)`` tensor steps. On the card each transition
replays CUDA graphs (``inference/graphs.py``) when its value+grad declares
that they may capture it (``graph_safe``); elsewhere, and on the CPU, the
same parts of the transition run eagerly, ``graphs.PAIRS_PER_REPLAY`` pair
iterations per host check, so the CPU runs the code that the graphs
capture. Adaptation statistics are chain means, as in the reference's
single-device path.

Randomness: step ``t`` (warmup and draws share one global counter) draws
each chain's momenta and NUTS uniform table from Philox keyed on
``(seed, chain, t)`` (``ops/random.py``; one kernel launch per step on the
card) - the counterpart of the reference's ``fold_in(chain_key, t)``. A
chain's draws depend only on its global index, never on how many chains run
beside it, and any step's draws can be regenerated. The step-size probe uses
step index ``0x7FFFFFFF``, as the reference does.

Host syncs: each transition reads ``active.any()`` after its root and after
each pairs replay (none with ``static_schedule=True``), and each probe of
the step-size search reads the pooled accept rate; ``ChainResult`` reports
their count and the graph replays. The draw store and all per-draw
diagnostics stay on the device.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from mlx_mcmc_tpu_torch.kernels.adaptation import (
    AdaptationState,
    adaptation_init,
    adaptation_update,
    build_schedule,
    find_reasonable_step_size,
)
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.kernels.integrators import (
    IntegratorState,
    leapfrog,
    sample_momentum,
    total_energy,
)
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
from mlx_mcmc_tpu_torch.ops.random import step_draws

DEFAULT_TARGET_ACCEPT = 0.65  # the reference's NUTS default
_PROBE_STEP = 0x7FFFFFFF


class ChainResult(NamedTuple):
    """Raw engine output, on the device.

    ``positions``: (chains, draws, D) in the store dtype. ``info``:
    TransitionInfo with (chains, draws) fields. ``host_syncs``: device-to-host
    syncs the run made (probe reads plus one per NUTS pair-loop check).
    ``graph_replays``: replays of the transition's CUDA graphs (0 when the
    transitions ran eagerly).
    """

    positions: torch.Tensor
    info: TransitionInfo
    final_tunables: Tunables
    final_state: Any
    final_adapt: AdaptationState
    host_syncs: int
    graph_replays: int = 0


def step_inputs(seed: int, chains: torch.Tensor, t: int, inv_mass_diag: torch.Tensor, n_slots: int):
    """Global step ``t``'s random inputs for the chains ``chains`` (global
    indices): momenta ``r0 (C, D)`` for ``inv_mass_diag`` and the NUTS
    uniform table ``U (C, n_slots, 4)``."""
    normals, U = step_draws(seed, chains, t, inv_mass_diag.shape[0], n_slots)
    return sample_momentum(normals, inv_mass_diag), U


def data_key(data):
    """A hashable key of ``data`` by identity, or None if it holds
    something other than tensors (by id, shape, dtype and device), numbers,
    strings and None, in dicts, lists and tuples. What a CUDA graph bakes
    in of the data: the tensors' addresses and every other value."""
    if data is None or isinstance(data, (bool, int, float, str)):
        return ("value", data)
    if isinstance(data, torch.Tensor):
        return ("tensor", id(data), tuple(data.shape), data.dtype, data.device)
    if isinstance(data, dict):
        items = tuple((k, data_key(v)) for k, v in sorted(data.items(), key=lambda kv: str(kv[0])))
        return None if any(v is None for _, v in items) else ("dict", items)
    if isinstance(data, (list, tuple)):
        items = tuple(data_key(v) for v in data)
        return None if any(v is None for v in items) else ("seq", items)
    return None


def make_batched_value_and_grad(flat_log_prob: Callable, data=None):
    """Batched value+grad by autograd for models without a fused one.

    The per-chain model runs under ``torch.func.vmap`` over the chain axis
    and one reverse pass of the chain sum gives every chain's gradient
    (chains are independent). Same numbers as
    ``vmap(grad_and_value(flat_log_prob))`` at lower dispatch cost: 1.53 vs
    2.08 ms per call for centered eight schools at 512 chains on an H100
    (``python -m mlx_mcmc_tpu_torch.bench loop``).

    CUDA graphs capture it (``graph_safe``) only where the model declared
    that they may: ``flat_log_prob.graph_safe``, which ``make_flat_logprob``
    takes from the model's own ``graph_safe`` (the eight-schools models set
    it). A model may do what a capture forbids (read a value on the host,
    make a tensor from host data), so an undeclared one runs eagerly. On the
    H100 the funnel's transition captures and gives the eager loop's bits
    (``chip_smoke.py`` phase 3c).
    """
    if data is None:
        batched = torch.func.vmap(flat_log_prob)
    else:
        batched = torch.func.vmap(lambda z: flat_log_prob(z, data))

    def vag(Z):
        with torch.enable_grad():
            Z = Z.detach().requires_grad_(True)
            value = batched(Z)
            (grad,) = torch.autograd.grad(value.sum(), Z)
        return value.detach(), grad

    vag.graph_safe = bool(getattr(flat_log_prob, "graph_safe", False))
    return vag


def resolve_step_size(step_size, adapt_step_size: bool):
    """The public ``step_size`` argument: a float, or ``'auto'`` (the
    default) for the Stan-style probe; ``'auto'`` with
    ``adapt_step_size=False`` pins 0.1, as the reference does
    (``mlx_mcmc_tpu/inference/engine.py:resolve_step_size``)."""
    if isinstance(step_size, str):
        if step_size != "auto":
            raise ValueError(f"step_size must be a float or 'auto', got {step_size!r}")
        if not adapt_step_size:
            return 0.1
    return step_size


def build_sampler(
    flat_log_prob: Optional[Callable],
    dim: int,
    *,
    kernel: str = "nuts",
    num_warmup: int = 1000,
    num_samples: int = 1000,
    thin: int = 1,
    step_size="auto",
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    store_dtype=None,
    max_tree_depth: int = 10,
    value_and_grad_fn: Optional[Callable] = None,
    static_schedule: bool = False,
) -> Callable[..., ChainResult]:
    """Build ``run(seed, z0_batch, data=None) -> ChainResult``.

    With ``step_size='auto'`` the step size starts from the Stan-style
    probe, otherwise from ``step_size``; it adapts by dual averaging unless
    ``adapt_step_size=False``, which keeps ``step_size`` for every step. The
    diagonal mass matrix adapts in the windowed schedule unless
    ``adapt_mass_matrix=False``, which keeps the unit metric.
    ``value_and_grad_fn(Z, data) -> (ll (C,), g (C, D))`` replaces autograd
    (the fused GLM path); otherwise ``flat_log_prob`` (``(z)`` or
    ``(z, data)``) is differentiated per chain. ``store_dtype`` down-casts
    only the stored draws; every step's arithmetic stays float32.
    ``static_schedule=True`` runs the reference's fixed-trip pair loop: the
    same draws, no host read inside a transition.

    On the card, a ``value_and_grad_fn`` with ``graph_safe = True`` runs
    through :class:`graphs.GraphedTransition`; ``run`` keeps the graphs of
    its last call and replays them in the next call with the same device,
    chain count and ``data`` (by identity: :func:`data_key`).
    """
    if kernel != "nuts":
        raise NotImplementedError(f"kernel={kernel!r} is not ported yet (nuts only)")
    if thin != 1:
        raise NotImplementedError("thin != 1 is not ported yet")
    if target_accept is None:
        target_accept = DEFAULT_TARGET_ACCEPT
    auto_step_size = isinstance(step_size, str)
    if auto_step_size and (step_size != "auto" or not adapt_step_size):
        raise ValueError("step_size='auto' requires adapt_step_size=True")
    schedule = build_schedule(num_warmup, adapt_mass_matrix=adapt_mass_matrix)

    def _tunables(adapt: AdaptationState, log_step) -> Tunables:
        eps = torch.exp(log_step) if adapt_step_size else torch.full_like(log_step, step_size)
        return Tunables(step_size=eps, inv_mass_diag=adapt.inv_mass_diag)

    last_graphs = {}  # the graphs of the last run, by what they bake in

    def run(seed: int, z0_batch: torch.Tensor, data=None) -> ChainResult:
        device = z0_batch.device
        num_chains = z0_batch.shape[0]
        if value_and_grad_fn is not None:
            source = value_and_grad_fn
            vag = (lambda Z: value_and_grad_fn(Z, data)) if data is not None else value_and_grad_fn
        else:
            source = vag = make_batched_value_and_grad(flat_log_prob, data)
        transition = None
        if device.type == "cuda" and graphs.captures(source):
            key = (device, num_chains, data_key(data), graphs.PAIRS_PER_REPLAY)
            transition = last_graphs.get(key)
            if transition is None:
                last_graphs.clear()
                transition = graphs.GraphedTransition(vag, max_tree_depth, static_schedule)
                if key[2] is not None:
                    last_graphs[key] = transition
            step_fn = transition.step
            replays0 = transition.replays
        else:
            _, step_fn = make_nuts_kernel(
                vag, max_tree_depth=max_tree_depth, pairs_per_check=graphs.PAIRS_PER_REPLAY,
                static_schedule=static_schedule)
        log_prob0, grad0 = vag(z0_batch)
        states = HMCState(position=z0_batch, log_prob=log_prob0, grad=grad0)
        chains = torch.arange(num_chains, device=device)
        n_slots = 1 << (max_tree_depth - 1)

        if auto_step_size:
            # Stan-style initialization: one leapfrog across all chains,
            # doubling/halving eps until the mean accept crosses 0.5.
            inv_mass0 = torch.ones((dim,), dtype=torch.float32, device=device)
            r, _ = step_inputs(seed, chains, _PROBE_STEP, inv_mass0, 0)
            start = IntegratorState(states.position, r, states.log_prob, states.grad)
            e0 = total_energy(start, inv_mass0)

            def accept_prob_fn(eps: float) -> float:
                eps_t = torch.tensor(eps, dtype=torch.float32, device=device)
                e1 = total_energy(leapfrog(start, eps_t, inv_mass0, vag), inv_mass0)
                delta = e0 - e1
                delta = torch.where(torch.isnan(delta), -float("inf"), delta)
                return float(torch.exp(torch.clamp(delta, max=0.0)).mean())

            eps_init, host_syncs = find_reasonable_step_size(accept_prob_fn)
        else:
            eps_init, host_syncs = step_size, 0
        adapt = adaptation_init(dim, eps_init, device=device)

        def one_step(states, t, tunables):
            r0, U = step_inputs(seed, chains, t, tunables.inv_mass_diag, n_slots)
            return step_fn(states, tunables, r0, U)

        for t in range(num_warmup):
            tunables = _tunables(adapt, adapt.da.log_step)
            states, infos, syncs = one_step(states, t, tunables)
            host_syncs += syncs
            adapt = adaptation_update(
                adapt,
                infos.accept_prob.mean(),
                states.position,
                bool(schedule.in_slow_window[t]),
                bool(schedule.window_end[t]),
                target_accept,
            )

        tunables = _tunables(adapt, adapt.da.log_step_avg)
        store = torch.empty(
            (num_samples, num_chains, dim), dtype=store_dtype or torch.float32, device=device
        )
        info_store = None
        for j in range(num_samples):
            states, infos, syncs = one_step(states, num_warmup + j, tunables)
            host_syncs += syncs
            store[j] = states.position
            if info_store is None:
                info_store = TransitionInfo(
                    *(torch.empty((num_samples,) + x.shape, dtype=x.dtype, device=device)
                      for x in infos)
                )
            for buf, x in zip(info_store, infos):
                buf[j] = x

        if info_store is None:  # num_samples == 0
            info_store = TransitionInfo(
                *(torch.empty((0, num_chains), device=device) for _ in TransitionInfo._fields)
            )
        return ChainResult(
            positions=store.transpose(0, 1),
            info=TransitionInfo(*(x.transpose(0, 1) for x in info_store)),
            final_tunables=tunables,
            # a graph's outputs are overwritten by its next replay
            final_state=HMCState(*(t.clone() for t in states)),
            final_adapt=adapt,
            host_syncs=host_syncs,
            graph_replays=0 if transition is None else transition.replays - replays0,
        )

    return run
