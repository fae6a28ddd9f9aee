"""Multi-chain sampling engine: init -> step-size probe -> warmup -> draws.

Counterpart of ``build_sampler`` in ``mlx_mcmc_tpu/inference/engine.py``
(every kernel: Metropolis, HMC, NUTS, ChEES, MALA; warmup segments and
draw offsets). The reference's two ``lax.scan`` loops become Python
loops over batched ``(C, D)`` tensor steps. On the card each transition
replays CUDA graphs (``inference/graphs.py``) when its value+grad declares
that they may capture it (``graph_safe``); elsewhere, and on the CPU, the
same parts of the transition run eagerly, ``graphs.PAIRS_PER_REPLAY`` pair
iterations per host check, so the CPU runs the code that the graphs
capture. Adaptation statistics are chain means, as in the reference's
single-device path, or pooled over a process group's ranks where chains
are sharded (``group``, the reference's ``axis_name``).

Randomness: step ``t`` (warmup and draws share one global counter) draws
each chain's momenta and NUTS uniform table from Philox keyed on
``(seed, chain, t)`` (``ops/random.py``; one kernel launch per step on the
card) - the counterpart of the reference's ``fold_in(chain_key, t)``. A
chain's draws depend only on its global index, never on how many chains run
beside it, and any step's draws can be regenerated. The step-size probe uses
step index ``0x7FFFFFFF``, as the reference does.

Host syncs: each NUTS transition reads ``active.any()`` after its root and
after each pairs replay (none with ``static_schedule=True``), each probe of
the step-size search reads the pooled accept rate, and ChEES reads its
leapfrog count once per warmup step and once for all the steps of a
sampling phase (``kernels/chees.py``); ``ChainResult`` reports their count
and the graph replays. The draw store and all per-draw diagnostics stay on
the device.

Segments: ``warmup_start``/``warmup_stop`` run a slice ``[start, stop)`` of
the warmup schedule, continuing from ``resume_state=(adapt, traj)``, and
``run``'s ``sample_start`` offsets the draws' global steps. Every random
input and every schedule flag is a function of the global step index, so a
run cut into segments gives the uninterrupted run's bits (``sample()``'s
``draw_chunk``; checkpoint and resume).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch.kernels.adaptation import (
    AdaptationState,
    adaptation_init,
    adaptation_update,
    build_schedule,
    find_reasonable_step_size,
)
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.kernels.chees import (
    ChEESInfo,
    chees_gradient,
    halton_device,
    halton_sequence,
    make_chees_kernel,
    make_chees_parts,
    num_leapfrogs,
    trajectory_init,
    trajectory_update,
)
from mlx_mcmc_tpu_torch.kernels.integrators import (
    IntegratorState,
    leapfrog,
    sample_momentum,
    total_energy,
)
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.kernels.hmc import make_hmc_kernel
from mlx_mcmc_tpu_torch.kernels.mala import make_mala_kernel
from mlx_mcmc_tpu_torch.kernels.metropolis import make_metropolis_kernel
from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
from mlx_mcmc_tpu_torch.ops.math import welford_psum_merge
from mlx_mcmc_tpu_torch.ops.random import step_draws

_DEFAULT_TARGET_ACCEPT = {
    "metropolis": 0.234,
    "hmc": 0.8,
    "nuts": 0.65,
    "chees": 0.651,  # the ChEES paper's harmonic-mean acceptance target
    "mala": 0.574,  # optimal scaling of Langevin proposals
}
_PROBE_STEP = 0x7FFFFFFF
# Reserved step index of the chains' jittered starts (``jittered_starts``):
# neither a sampling step nor the probe's.
JITTER_STEP = 0x7FFFFFFE
# Kernels that take raw standard normals (a proposal's noise), not momenta.
_NOISE_KERNELS = ("metropolis", "mala")
_ENDPOINT_FIELDS = ("proposal_position", "end_velocity")


def default_target_accept(kernel: str) -> float:
    return _DEFAULT_TARGET_ACCEPT[kernel]


class ChainResult(NamedTuple):
    """Raw engine output, on the device.

    ``positions``: (chains, draws, D) in the store dtype. ``info``:
    TransitionInfo (ChEES: ``ChEESInfo`` with its endpoint fields stripped
    to width 0) with (chains, draws) fields. ``final_adapt`` and
    ``final_traj`` (ChEES's ``TrajectoryAdaptState``, ``()`` for the other
    kernels): the adaptation state at the end of the run's warmup segment,
    what a continuation takes as ``resume_state``. ``host_syncs``:
    device-to-host syncs the run made (probe reads, NUTS pair-loop checks,
    ChEES count reads). ``graph_replays``: replays of the transition's CUDA
    graphs (0 when the transitions ran eagerly). ``leapfrog_counts``
    (ChEES): the leapfrog count of every transition run, warmup first, as
    the host read them. ``probe_evals``: the step-size probe's one-leapfrog
    evaluations (each one value+grad and one host read; 0 without a probe).
    ``collectives``: with a process group, the run's
    ``parallel.distributed.Collectives`` (count and time of its pooling);
    None without one.
    """

    positions: torch.Tensor
    info: TransitionInfo
    final_tunables: Tunables
    final_state: Any
    final_adapt: AdaptationState
    host_syncs: int
    graph_replays: int = 0
    final_traj: Any = ()
    leapfrog_counts: tuple = ()
    probe_evals: int = 0
    collectives: Any = None


def step_inputs(seed: int, chains: torch.Tensor, t: int, inv_mass_diag: torch.Tensor, n_slots: int):
    """Global step ``t``'s random inputs for the chains ``chains`` (global
    indices): momenta ``r0 (C, D)`` for ``inv_mass_diag`` (``(D,)``, or
    ``(C, D)`` per row) and the NUTS uniform table ``U (C, n_slots, 4)``."""
    normals, U = step_draws(seed, chains, t, inv_mass_diag.shape[-1], n_slots)
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


def data_fingerprint(data):
    """A structural fingerprint of ``data``: for each leaf, in JAX's
    flattening order (dict keys sorted; None is no leaf), its
    ``jax.tree_util.keystr`` path (``"['X']"``, ``"[0]"``, ``".field"``),
    its shape and its dtype's name, as the reference's checkpoints record
    it (``mlx_mcmc_tpu/io/checkpoint.py:_data_fingerprint``), so that
    either package's checkpoint checks the other's data. None for no
    data. Reads no values."""
    if data is None:
        return None
    out = []

    def walk(node, path):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, tuple) and hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), f"{path}.{name}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif isinstance(node, torch.Tensor):
            out.append([path, list(node.shape), str(node.dtype).removeprefix("torch.")])
        else:
            dtype = node.dtype if hasattr(node, "dtype") else np.asarray(node).dtype
            out.append([path, list(np.shape(node)), str(dtype)])

    walk(data, "")
    return out


def vmap_log_prob(flat_log_prob: Callable, data=None) -> Callable:
    """The per-chain flat log density under ``torch.func.vmap``: ``(C, D)
    -> (C,)``, ``data`` bound where given."""
    if data is None:
        return torch.func.vmap(flat_log_prob)
    return torch.func.vmap(lambda z: flat_log_prob(z, data))


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
    batched = vmap_log_prob(flat_log_prob, data)

    def vag(Z):
        with torch.enable_grad():
            Z = Z.detach().requires_grad_(True)
            value = batched(Z)
            (grad,) = torch.autograd.grad(value.sum(), Z)
        return value.detach(), grad

    vag.graph_safe = bool(getattr(flat_log_prob, "graph_safe", False))
    return vag


def make_batched_value(flat_log_prob: Callable, data=None):
    """Batched log density ``value(Z (C, D)) -> (C,)`` for Metropolis: the
    per-chain model under ``torch.func.vmap``, no gradient. Graph-safe
    where the model declared it, as :func:`make_batched_value_and_grad`."""
    batched = vmap_log_prob(flat_log_prob, data)

    def value(Z):
        with torch.no_grad():
            return batched(Z)

    value.graph_safe = bool(getattr(flat_log_prob, "graph_safe", False))
    return value


def batched_density(kernel: str, flat_log_prob: Optional[Callable],
                    value_and_grad_fn: Optional[Callable], data=None):
    """``(batched, vag)``: what ``kernel``'s transitions evaluate and the
    batched value+grad. ``vag`` is ``value_and_grad_fn`` with ``data``
    bound where one is given, else autograd of ``flat_log_prob``
    (:func:`make_batched_value_and_grad`; None for Metropolis); ``batched``
    is ``vag``, or for Metropolis the value alone (the model's, else
    ``vag``'s first output). Each carries its ``graph_safe``."""
    if value_and_grad_fn is not None:
        def vag(Z):
            return value_and_grad_fn(Z) if data is None else value_and_grad_fn(Z, data)

        vag.graph_safe = graphs.captures(value_and_grad_fn)
    else:
        vag = None if kernel == "metropolis" else make_batched_value_and_grad(flat_log_prob, data)
    if kernel != "metropolis":
        return vag, vag
    if flat_log_prob is not None:
        return make_batched_value(flat_log_prob, data), vag

    def batched(Z):
        return vag(Z)[0]

    batched.graph_safe = vag.graph_safe
    return batched, vag


def graphed_transition(last_graphs: dict, kernel: str, batched: Callable, step_fn: Callable,
                       device, num_chains: int, data, max_tree_depth: int,
                       static_schedule: bool):
    """A run's transition as CUDA graphs, or None where it runs eagerly
    (on the CPU, or where ``batched`` does not declare ``graph_safe``):
    :class:`graphs.GraphedTransition` (NUTS), :class:`graphs.GraphedTrajectory`
    (ChEES) or :class:`graphs.GraphedStep` around ``step_fn``. A runner
    keeps the graphs of its last call in ``last_graphs``, by what they bake
    in (device, chain count, ``data`` by identity), and replays them in the
    next call with the same."""
    if device.type != "cuda" or not graphs.captures(batched):
        return None
    key = (device, num_chains, data_key(data), graphs.PAIRS_PER_REPLAY)
    transition = last_graphs.get(key)
    if transition is None:
        last_graphs.clear()
        if kernel == "nuts":
            transition = graphs.GraphedTransition(batched, max_tree_depth, static_schedule)
        elif kernel == "chees":
            transition = graphs.GraphedTrajectory(make_chees_parts(batched))
        else:
            transition = graphs.GraphedStep(step_fn)
        if key[2] is not None:
            last_graphs[key] = transition
    return transition


def _check_kernel(kernel: str) -> None:
    if kernel not in _DEFAULT_TARGET_ACCEPT:
        raise ValueError(f"Unknown kernel: {kernel!r}")


def make_kernel(kernel: str, batched: Callable, *, num_leapfrog_steps: int = 10,
                max_tree_depth: int = 10, static_schedule: bool = False,
                max_leapfrog_steps: int = 1000):
    """Kernel factory by name, as the reference's ``make_kernel``:
    ``(init_fn, step_fn)`` over ``batched``, a batched value
    (Metropolis) or value+grad (HMC, NUTS, ChEES, MALA). ``step_fn(state,
    tunables, x, U) -> (state, info, host_syncs)``, with ``x`` the step's
    momenta (HMC, NUTS, ChEES) or standard normals (Metropolis, MALA);
    ChEES's takes the step's leapfrog count as a fifth argument, at most
    ``max_leapfrog_steps``."""
    _check_kernel(kernel)
    if kernel == "metropolis":
        return make_metropolis_kernel(batched)
    if kernel == "hmc":
        return make_hmc_kernel(batched, num_leapfrog_steps=num_leapfrog_steps)
    if kernel == "mala":
        return make_mala_kernel(batched)
    if kernel == "chees":
        return make_chees_kernel(batched, max_leapfrog_steps=max_leapfrog_steps)
    return make_nuts_kernel(batched, max_tree_depth=max_tree_depth,
                            pairs_per_check=graphs.PAIRS_PER_REPLAY,
                            static_schedule=static_schedule)


def strip_endpoints(info):
    """ChEES's info with its endpoint fields cut to width 0: the draws do
    not store them (the reference's ``engine.py:437-446``; at 4096 chains,
    D = 100 and 2,000 draws they would add 6.6 GB)."""
    return info._replace(**{k: getattr(info, k)[..., :0] for k in _ENDPOINT_FIELDS})


def resolve_step_size(step_size, kernel: str, adapt_step_size: bool):
    """The public ``step_size`` argument: a float, or ``'auto'`` (the
    default) for the Stan-style probe of the gradient kernels; ``'auto'``
    pins 0.1 for Metropolis (no gradient) and with
    ``adapt_step_size=False``, as the reference does
    (``mlx_mcmc_tpu/inference/engine.py:resolve_step_size``)."""
    if isinstance(step_size, str):
        if step_size != "auto":
            raise ValueError(f"step_size must be a float or 'auto', got {step_size!r}")
        if kernel == "metropolis" or not adapt_step_size:
            return 0.1
    return step_size


def jittered_starts(seed: int, z0_batch: torch.Tensor, jitter: float,
                    first_chain: int = 0) -> torch.Tensor:
    """``z0_batch + jitter * N(0, 1)``, chain ``i``'s normals from Philox at
    ``(seed, i, JITTER_STEP)``, the rows numbered from ``first_chain`` (a
    rank's block of sharded chains): a chain's start does not depend on
    how many chains run or where (the reference draws one joint ``(C, D)``
    normal, which does)."""
    chains = first_chain + torch.arange(z0_batch.shape[0], device=z0_batch.device)
    normals, _ = step_draws(seed, chains, JITTER_STEP, z0_batch.shape[1], 0)
    return z0_batch + jitter * normals


def _default_progress(phase, t, accept, eps):
    print(f"  [{phase}] step {int(t):6d}  mean accept {float(accept):.3f}"
          f"  step size {float(eps):.4f}", flush=True)


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
    num_leapfrog_steps: int = 10,
    max_leapfrog_steps: int = 1000,
    value_and_grad_fn: Optional[Callable] = None,
    static_schedule: bool = False,
    init_inv_mass_diag=None,
    progress_every: Optional[int] = None,
    progress_callback: Optional[Callable] = None,
    warmup_start: int = 0,
    warmup_stop: Optional[int] = None,
    collect_warmup: bool = False,
    group=None,
) -> Callable[..., ChainResult]:
    """Build ``run(seed, z0_batch, data=None, resume_state=None,
    sample_start=0, *, num_samples, warmup_start, warmup_stop,
    init_inv_mass_diag) -> ChainResult``; the last four default to the
    values given here.

    ``kernel`` is 'metropolis', 'hmc' (``num_leapfrog_steps`` leapfrogs),
    'nuts' (``max_tree_depth``, ``static_schedule``), 'chees' (at most
    ``max_leapfrog_steps`` leapfrogs a transition) or 'mala'. With
    ``step_size='auto'`` the step size of a gradient kernel starts from the
    Stan-style probe, otherwise from ``step_size``; it adapts by dual
    averaging toward ``target_accept`` (the kernel's default: 0.234, 0.8,
    0.65, 0.651, 0.574) unless ``adapt_step_size=False``, which keeps
    ``step_size`` for every step. The diagonal inverse mass matrix starts at
    ``init_inv_mass_diag`` (ones by default; the probe uses it too) and
    adapts in the windowed schedule unless ``adapt_mass_matrix=False``.
    ChEES's trajectory length starts at the initial step size and adapts in
    every warmup step (Adam on the ChEES criterion); its stored draws carry
    no endpoint fields (:func:`strip_endpoints`).
    ``value_and_grad_fn(Z, data) -> (ll (C,), g (C, D))`` replaces autograd
    (the fused GLM path; Metropolis takes its value); otherwise
    ``flat_log_prob`` (``(z)`` or ``(z, data)``) is evaluated per chain.
    ``store_dtype`` down-casts only the stored draws; every step's
    arithmetic stays float32. ``static_schedule=True`` runs NUTS's
    fixed-trip pair loop: the same draws, no host read inside a transition.

    ``thin`` keeps every ``thin``-th draw: stored draw ``j`` is the last of
    the steps ``num_warmup + (sample_start + j)*thin + i`` (``i < thin``),
    with ``is_divergent`` the block's any and ``num_integration_steps`` its
    sum. ``progress_every=n`` calls ``progress_callback(phase, t, mean
    accept, step size)`` (default: a printed line) after every step ``t``
    with ``(t + 1) % n == 0`` (a thinned block reports at its first step's
    index, as the reference does); each report is one host read, counted
    in ``host_syncs``.

    ``warmup_start``/``warmup_stop`` select the segment ``[start, stop)`` of
    the ``num_warmup``-step schedule; a run that starts past 0 continues
    from ``resume_state=(adapt, traj)`` (an earlier run's ``final_adapt``
    and ``final_traj``), which also skips the probe. ``num_samples=0``
    stops after the warmup segment, and ``sample_start`` offsets the
    draws, so the segments of a run give its uninterrupted bits. A call may
    run another segment, draw count or initial metric than the build's
    (``sample()``'s ``draw_chunk`` continuations: no warmup, one chunk of
    draws; a checkpoint's continuation) and replays the same graphs.

    ``collect_warmup=True``: ``run`` returns ``(ChainResult, (positions,
    infos))``, the warmup segment's states as the reference's scan collects
    them: ``positions`` ``(W_seg, C, D)`` float32 after each warmup step
    and ``infos`` its transitions' ``TransitionInfo`` (ChEES: ``ChEESInfo``
    with the endpoint fields) stacked on a leading step axis; ``None`` for
    an empty segment. Each step's state is copied out after the step,
    outside its graphs: the draws, tunables, host syncs and launches are
    those of the run without collecting.

    On the card, a value (+grad) with ``graph_safe = True`` runs through
    :class:`graphs.GraphedTransition` (NUTS), :class:`graphs.GraphedTrajectory`
    (ChEES) or :class:`graphs.GraphedStep`; ``run`` keeps the graphs of its
    last call and replays them in the next call with the same device, chain
    count and ``data`` (by identity: :func:`data_key`).

    ``group``: a process group whose ranks share the chains
    (``parallel.sample_sharded``). Each rank's ``z0_batch`` is its block of
    the chains, numbered from ``rank * C_local`` for every random draw.
    The probe's and each warmup step's mean accept are the mean over ranks
    of each rank's chain mean (the reference's ``pmean`` of ``jnp.mean``),
    the Welford moments pool at window ends
    (``ops.math.welford_psum_merge``) and ChEES's gradient pools its chain
    means (:func:`chees_gradient`), so every rank adapts the same
    tunables. The collectives run between transitions, never inside a
    captured graph; ``ChainResult.collectives`` counts and times them.
    """
    _check_kernel(kernel)
    if target_accept is None:
        target_accept = default_target_accept(kernel)
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    auto_step_size = isinstance(step_size, str)
    if auto_step_size and (step_size != "auto" or kernel == "metropolis"
                           or not adapt_step_size):
        raise ValueError("step_size='auto' requires a gradient kernel (hmc/nuts/chees/mala) "
                         "with adapt_step_size=True")
    if warmup_stop is None:
        warmup_stop = num_warmup
    _check_segment(warmup_start, warmup_stop, num_warmup)
    is_chees = kernel == "chees"
    schedule = build_schedule(num_warmup, adapt_mass_matrix=adapt_mass_matrix)
    report = progress_callback or _default_progress
    n_slots = 1 << (max_tree_depth - 1) if kernel == "nuts" else 1

    def _tunables(adapt: AdaptationState, log_step) -> Tunables:
        eps = torch.exp(log_step) if adapt_step_size else torch.full_like(log_step, step_size)
        return Tunables(step_size=eps, inv_mass_diag=adapt.inv_mass_diag)

    last_graphs = {}  # the graphs of the last run, by what they bake in

    def run(seed: int, z0_batch: torch.Tensor, data=None, resume_state=None,
            sample_start: int = 0, *, num_samples: int = num_samples,
            warmup_start: int = warmup_start, warmup_stop: int = warmup_stop,
            init_inv_mass_diag=init_inv_mass_diag) -> ChainResult:
        _check_segment(warmup_start, warmup_stop, num_warmup)
        device = z0_batch.device
        num_chains = z0_batch.shape[0]
        if resume_state is None and warmup_start > 0:
            raise ValueError("warmup_start > 0 requires resume_state=(adapt, traj) from the "
                             "prior segment's ChainResult")
        batched, vag = batched_density(kernel, flat_log_prob, value_and_grad_fn, data)
        init_fn, step_fn = make_kernel(kernel, batched, num_leapfrog_steps=num_leapfrog_steps,
                                       max_tree_depth=max_tree_depth,
                                       static_schedule=static_schedule,
                                       max_leapfrog_steps=max_leapfrog_steps)
        transition = graphed_transition(last_graphs, kernel, batched, step_fn, device,
                                        num_chains, data, max_tree_depth, static_schedule)
        if transition is not None:
            step_fn = transition.step
            replays0 = transition.replays
        states = init_fn(z0_batch)
        pool = welford_reduce = chees_pmean = None
        first_chain = 0
        if group is not None:
            from mlx_mcmc_tpu_torch.parallel.distributed import Collectives

            pool = Collectives(group)
            first_chain = pool.rank * num_chains
            chees_pmean = pool.pmean

            def welford_reduce(w):
                return welford_psum_merge(w, pool.psum)

        def pooled_mean(x: torch.Tensor) -> torch.Tensor:
            m = x.mean()
            return m if pool is None else pool.pmean(m)

        chains = first_chain + torch.arange(num_chains, device=device)
        host_syncs = probe_evals = 0

        if resume_state is not None:
            # Continue an earlier segment: its adaptation state replaces the
            # probe and adaptation_init.
            adapt, traj = resume_state
            if not is_chees:
                traj = ()
        else:
            inv_mass0 = (torch.ones((dim,), dtype=torch.float32, device=device)
                         if init_inv_mass_diag is None else
                         torch.as_tensor(init_inv_mass_diag, dtype=torch.float32, device=device))
            if auto_step_size:
                # Stan-style initialization: one leapfrog across all chains,
                # doubling/halving eps until the mean accept crosses 0.5.
                r, _ = step_inputs(seed, chains, _PROBE_STEP, inv_mass0, 0)
                start = IntegratorState(states.position, r, states.log_prob, states.grad)
                e0 = total_energy(start, inv_mass0)

                def accept_prob_fn(eps: float) -> float:
                    eps_t = torch.tensor(eps, dtype=torch.float32, device=device)
                    e1 = total_energy(leapfrog(start, eps_t, inv_mass0, vag), inv_mass0)
                    delta = e0 - e1
                    delta = torch.where(torch.isnan(delta), -float("inf"), delta)
                    return float(pooled_mean(torch.exp(torch.clamp(delta, max=0.0))))

                eps_init, probe_evals = find_reasonable_step_size(accept_prob_fn)
                host_syncs = probe_evals
            else:
                eps_init = step_size
            adapt = adaptation_init(dim, eps_init, inv_mass0, device=device)
            traj = trajectory_init(eps_init, device=device) if is_chees else ()
        counts = []  # ChEES: each transition's leapfrog count, as read
        warm_positions = warm_infos = None
        if collect_warmup and warmup_stop > warmup_start:
            warm_positions = torch.empty((warmup_stop - warmup_start, num_chains, dim),
                                         dtype=torch.float32, device=device)

        def one_step(states, t, tunables, num_steps=None):
            if kernel in _NOISE_KERNELS:
                x, U = step_draws(seed, chains, t, dim, n_slots)
            else:
                x, U = step_inputs(seed, chains, t, tunables.inv_mass_diag, n_slots)
            if is_chees:
                counts.append(num_steps)
                return step_fn(states, tunables, x, U, num_steps)
            return step_fn(states, tunables, x, U)

        def maybe_report(phase, t, infos, tunables) -> int:
            if not progress_every or (t + 1) % progress_every:
                return 0
            accept, eps = torch.stack([infos.accept_prob.mean(), tunables.step_size]).tolist()
            report(phase, t, accept, eps)
            return 1

        for t in range(warmup_start, warmup_stop):
            tunables = _tunables(adapt, adapt.da.log_step)
            num_steps = None
            if is_chees:
                # This step's jittered trajectory: Halton of the global step,
                # the same for every chain; its count read on the host.
                u = halton_sequence(t)
                tunables = tunables._replace(trajectory_length=u * torch.exp(traj.log_tau))
                num_steps = int(num_leapfrogs(tunables.trajectory_length, tunables.step_size,
                                              max_leapfrog_steps))
                host_syncs += 1
                # a graph's outputs are overwritten by its next replay
                prev_positions = states.position.clone()
            states, infos, syncs = one_step(states, t, tunables, num_steps)
            host_syncs += syncs
            if warm_positions is not None:
                # copies: a graph's outputs are overwritten by its next replay
                warm_positions[t - warmup_start] = states.position
                if warm_infos is None:
                    warm_infos = type(infos)(*(
                        torch.empty((len(warm_positions),) + x.shape, dtype=x.dtype,
                                    device=device) for x in infos))
                for buf, x in zip(warm_infos, infos):
                    buf[t - warmup_start] = x
            adapt = adaptation_update(
                adapt,
                pooled_mean(infos.accept_prob),
                states.position,
                bool(schedule.in_slow_window[t]),
                bool(schedule.window_end[t]),
                target_accept,
                welford_reduce=welford_reduce,
            )
            if is_chees:
                grad = chees_gradient(prev_positions, infos, u, chees_pmean)
                traj = trajectory_update(traj, grad, tunables.step_size,
                                         max_leapfrog_steps=max_leapfrog_steps)
            host_syncs += maybe_report("warmup", t, infos, tunables)

        tunables = _tunables(adapt, adapt.da.log_step_avg)
        first_step = num_warmup + sample_start * thin
        if is_chees:
            # the adapted trajectory length, before the jitter
            tunables = tunables._replace(trajectory_length=torch.exp(traj.log_tau))
            if num_samples:
                # tau and eps are frozen: every step's count in one read
                steps = torch.arange(first_step, first_step + num_samples * thin, device=device)
                lengths = halton_device(steps) * torch.exp(traj.log_tau)
                sample_counts = num_leapfrogs(lengths, tunables.step_size,
                                              max_leapfrog_steps).tolist()
                host_syncs += 1
        store = torch.empty(
            (num_samples, num_chains, dim), dtype=store_dtype or torch.float32, device=device
        )
        info_store = None
        for j in range(num_samples):
            t0 = first_step + j * thin
            for i in range(thin):
                num_steps = sample_counts[j * thin + i] if is_chees else None
                states, infos, syncs = one_step(states, t0 + i, tunables, num_steps)
                host_syncs += syncs
                if is_chees:
                    infos = strip_endpoints(infos)
                if thin > 1 and i == 0:
                    divergent = infos.is_divergent.clone()
                    steps = infos.num_integration_steps.clone()
                elif thin > 1:
                    divergent |= infos.is_divergent
                    steps += infos.num_integration_steps
            if thin > 1:
                infos = infos._replace(is_divergent=divergent, num_integration_steps=steps)
            store[j] = states.position
            if info_store is None:
                info_store = type(infos)(
                    *(torch.empty((num_samples,) + x.shape, dtype=x.dtype, device=device)
                      for x in infos)
                )
            for buf, x in zip(info_store, infos):
                buf[j] = x
            host_syncs += maybe_report("sample", t0, infos, tunables)

        if info_store is None:  # num_samples == 0
            info_type = ChEESInfo if is_chees else TransitionInfo
            info_store = info_type(*(
                torch.empty((0, num_chains) + ((0,) if f in _ENDPOINT_FIELDS else ()),
                            device=device)
                for f in info_type._fields))
        result = ChainResult(
            positions=store.transpose(0, 1),
            info=type(info_store)(*(x.transpose(0, 1) for x in info_store)),
            final_tunables=tunables,
            # a graph's outputs are overwritten by its next replay
            final_state=type(states)(*(t.clone() for t in states)),
            final_adapt=adapt,
            host_syncs=host_syncs,
            graph_replays=0 if transition is None else transition.replays - replays0,
            final_traj=traj,
            leapfrog_counts=tuple(counts),
            probe_evals=probe_evals,
            collectives=pool,
        )
        if collect_warmup:
            return result, (None if warm_positions is None else (warm_positions, warm_infos))
        return result

    return run


def _check_segment(start: int, stop: int, num_warmup: int) -> None:
    if not 0 <= start <= stop <= num_warmup:
        raise ValueError(f"invalid warmup segment [{start}, {stop}) for "
                         f"num_warmup={num_warmup}")
