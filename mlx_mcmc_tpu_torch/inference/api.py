"""Functional sampling API: ``sample(...) -> MCMCResult``.

Counterpart of ``mlx_mcmc_tpu/inference/api.py:220-585``: the kernels
'metropolis', 'hmc', 'nuts', 'chees' and 'mala', ``data=``, ``num_chains``,
``seed``, ``jitter``, ``batched_initial``, ``transforms``, ``config``,
``init_strategy``, the tunables, ``thin``, ``store_dtype``,
``draw_chunk``, the kernel kwargs (``num_leapfrog_steps``,
``max_tree_depth``, ``max_leapfrog_steps``, ``static_schedule``,
``value_and_grad_fn``, ``init_inv_mass_diag``, ``progress_every``,
``progress_callback``), ``device``, ``init_strategy='advi'``
(``inference/vi.py``) and ``MCMCResult.resume_payload`` (what
``io/checkpoint.py`` saves and continues). Draws stay on the device until
numpy is asked for, except with ``draw_chunk``, which fetches every chunk
to the host. ``sample_posterior_predictive`` is the reference's
``api.py:588-639``, with ``torch.Generator``-taking predictive functions.

The compiled-runner cache (reference ``api.py:63-140, 331-367``) keeps, per
static configuration (:func:`runner_key`), the runner that
``build_sampler`` made and, inside it, the CUDA graphs of its transition
(``inference/graphs.py``), so a repeated ``sample()`` call, and
``io/checkpoint.py``'s ``run_warmup``, ``resume`` and ``resume_warmup``,
replay them instead of capturing them again.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.diagnostics.stats import (
    effective_sample_size,
    potential_scale_reduction,
    summary_stats,
)
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.distributions.transforms import make_transformed_logprob
from mlx_mcmc_tpu_torch.inference.engine import (
    build_sampler,
    data_fingerprint,
    data_key,
    jittered_starts,
    resolve_step_size,
)
from mlx_mcmc_tpu_torch.inference.init_strategies import map_initialize
from mlx_mcmc_tpu_torch.inference.vi import advi_initialize, batched_vag
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.ops.random import STREAM_UNIFORM, words
from mlx_mcmc_tpu_torch.ops.ravel import _leaves, make_flat_logprob, ravel_batched, ravel_params

# Compiled-runner cache: runs with the same static configuration reuse the
# runner and the CUDA graphs it captured, instead of capturing them again.
# As in the reference, functions are keyed by identity and the entry pins
# them, so ids cannot be recycled while cached; eviction is LRU. Unlike the
# reference, whose ``data`` and chain count are jit arguments, the graphs
# bake in the data tensors' addresses and the chain count, so both are part
# of the key (tensors by identity and shape). Transform instances are keyed
# by identity, as the reference keys them (by hash). What a run passes to
# its runner is not a key: the initial values, ``jitter``, the seed, the
# initial metric, the draw count and the segment (so ``draw_chunk``, a
# checkpoint's continuation and an 'advi' start reuse the runner).
# Mutating a cached ``data`` tensor in place needs ``clear_runner_cache()``,
# as mutating what a cached closure captures does in the reference.
_RUNNER_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_RUNNER_CACHE_MAX = 64


def clear_runner_cache() -> None:
    """Drop every cached runner and its graphs, ``sample_sharded``'s too.
    Call after mutating any object that a cached model, value+grad or
    ``data`` holds."""
    from mlx_mcmc_tpu_torch.parallel.sharded import clear_sharded_runner_cache

    _RUNNER_CACHE.clear()
    clear_sharded_runner_cache()


def _lru_get(cache: "OrderedDict", key):
    """LRU read: a hit moves to the back of the eviction queue."""
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _lru_put(cache: "OrderedDict", key, value, max_size: int) -> None:
    if len(cache) >= max_size:
        cache.popitem(last=False)  # evict least-recently-used
    cache[key] = value


def _param_spec(params) -> tuple:
    """The structure of ``params``: each leaf's path and shape."""
    return tuple((path, tuple(torch.as_tensor(v).shape)) for path, v in _leaves(params))


# The tunables' settings of a run, with sample()'s defaults; a checkpoint
# records them.
TUNABLE_SETTINGS = {"step_size": "auto", "adapt_step_size": True, "adapt_mass_matrix": True,
                    "target_accept": None, "store_dtype": None}
# The kernel kwargs that shape each kernel's transitions, with sample()'s
# defaults.
_KERNEL_OPTIONS = {
    "nuts": {"max_tree_depth": 10, "static_schedule": False},
    "hmc": {"num_leapfrog_steps": 10},
    "chees": {"max_leapfrog_steps": 1000},
    "mala": {},
    "metropolis": {},
}
_GIVEN_OPTIONS = ("value_and_grad_fn", "progress_every", "progress_callback")


def run_kwargs(kernel: str, options: dict) -> dict:
    """The kernel kwargs that a continuation of a run must repeat, from
    ``options`` (sample()'s kernel kwargs, or a checkpoint's with the
    caller's): ``thin``, the kernel's own options (NUTS's
    ``max_tree_depth`` and ``static_schedule``, HMC's
    ``num_leapfrog_steps``, ChEES's ``max_leapfrog_steps``; their defaults
    where absent) and ``value_and_grad_fn``, ``progress_every`` and
    ``progress_callback`` where given."""
    out = {"thin": int(options.get("thin", 1))}
    out.update({k: options.get(k, v) for k, v in _KERNEL_OPTIONS[kernel].items()})
    out.update({k: options[k] for k in _GIVEN_OPTIONS if options.get(k) is not None})
    return out


# Every sampler option a run may set: what run_settings reads, and the
# initial metric, which a runner takes per call.
RUN_OPTIONS = frozenset(TUNABLE_SETTINGS) | {"thin", "init_inv_mass_diag"} | frozenset(
    k for opts in _KERNEL_OPTIONS.values() for k in opts) | frozenset(_GIVEN_OPTIONS)


def run_settings(kernel: str, num_warmup: int, options: dict) -> dict:
    """What a runner bakes in, from ``options`` (sample()'s sampler kwargs,
    or a checkpoint's with the caller's; defaults where absent): the
    kernel, ``num_warmup``, the tunables' settings (``step_size`` resolved,
    the store dtype as a ``torch.dtype``) and :func:`run_kwargs`. The
    runner's build arguments and, with the model, its cache key
    (:func:`runner_key`). An option outside :data:`RUN_OPTIONS` raises."""
    unknown = sorted(set(options) - RUN_OPTIONS)
    if unknown:
        raise ValueError(f"unsupported sampler kwarg(s) {unknown}")
    tun = {k: options.get(k, v) for k, v in TUNABLE_SETTINGS.items()}
    adapt_step_size = bool(tun["adapt_step_size"])
    return dict(
        kernel=kernel, num_warmup=int(num_warmup),
        step_size=resolve_step_size(tun["step_size"], kernel, adapt_step_size),
        adapt_step_size=adapt_step_size, adapt_mass_matrix=bool(tun["adapt_mass_matrix"]),
        target_accept=tun["target_accept"], store_dtype=_as_dtype(tun["store_dtype"]),
        **run_kwargs(kernel, options))


def runner_key(log_prob_fn, example, data, num_chains: int, device, transforms, settings: dict):
    """The runner-cache key, or None where ``data`` cannot be keyed: what
    the runner and its graphs bake in. The functions and the data by
    identity, ``example``'s structure (one chain's parameters in the
    sampled space), the transforms, the chain count, the device and
    :func:`run_settings`'s ``settings``."""
    dkey = data_key(data)
    if dkey is None:
        return None
    tkey = None if transforms is None else tuple(sorted(transforms.items(), key=lambda kv: kv[0]))
    items = tuple(sorted((k, id(v) if callable(v) else v) for k, v in settings.items()))
    return (id(log_prob_fn), _param_spec(example), dkey, tkey, int(num_chains), device,
            graphs.PAIRS_PER_REPLAY, items)


def cached_runner(log_prob_fn, example, *, data, transforms, num_chains: int, device,
                  settings: dict, maps=None, build=build_sampler, cache=_RUNNER_CACHE,
                  key_extra: tuple = ()) -> dict:
    """The runner-cache entry for a run: the cached one under
    :func:`runner_key` (with its graphs), or a new one (:func:`model_entry`
    and ``build(flat_log_prob, dim, **settings)``: ``build_sampler`` for
    ``sample()``, another sampler's build function for its runs, whose
    ``settings`` name that sampler), cached where the key exists. ``cache``
    and ``key_extra`` (what else the runner bakes in) are
    ``sample_sharded``'s."""
    key = runner_key(log_prob_fn, example, data, num_chains, device, transforms, settings)
    key = None if key is None else key + tuple(key_extra)
    entry = None if key is None else _lru_get(cache, key)
    if entry is None:
        entry = model_entry(log_prob_fn, transforms, example, data, device, maps)
        entry["run"] = build(entry["flat_log_prob"], entry["dim"], **settings)
        # what the key names by id, so no id is recycled while cached
        entry["pin"] = (log_prob_fn, data, transforms, tuple(settings.values()))
        if key is not None:
            _lru_put(cache, key, entry, _RUNNER_CACHE_MAX)
    return entry


def resume_payload(result, unravel, **settings) -> dict:
    """A result's ``resume_payload``: the final positions and adaptation
    state of ``result`` (an engine ``ChainResult``), ``unravel`` and the
    run's ``settings``, which a continuation repeats."""
    position = result.final_state.position
    return dict(phase="sampling", flat_position=position, adapt=result.final_adapt,
                traj=result.final_traj, inv_mass_diag=result.final_tunables.inv_mass_diag,
                unravel=unravel, dim=int(position.shape[1]), **settings)


def dtype_name(dtype) -> Optional[str]:
    """A store dtype's name as the reference records it (``'bfloat16'``)."""
    return None if dtype is None else str(dtype).removeprefix("torch.")


def transformed(log_prob_fn, transforms, data) -> tuple:
    """``(log density in the sampled space, to_constrained,
    to_unconstrained)``: ``make_transformed_logprob``'s with transforms,
    the model itself and no maps without."""
    if transforms:
        return make_transformed_logprob(log_prob_fn, transforms, data_aware=data is not None)
    return log_prob_fn, None, None


def model_entry(log_prob_fn, transforms, example, data, device, maps=None) -> dict:
    """The model's part of a runner-cache entry: the flat log density over
    ``example``'s structure in the sampled space (None without
    ``log_prob_fn``), its width ``dim``, ``unravel`` and the transforms'
    maps (``maps``: :func:`transformed`'s, if made already).
    :func:`cached_runner` adds ``run`` and ``pin``."""
    lp_fn, to_constrained, to_unconstrained = maps or transformed(log_prob_fn, transforms, data)
    flat_log_prob, z_example, unravel = make_flat_logprob(
        lp_fn, example, data_aware=data is not None, device=device)
    return {
        "flat_log_prob": flat_log_prob if log_prob_fn is not None else None,
        "dim": z_example.shape[0],
        "unravel": unravel,
        "to_constrained": to_constrained,
        "to_unconstrained": to_unconstrained,
    }


@dataclass
class MCMCResult:
    """Posterior draws plus per-draw sampler diagnostics.

    ``samples``: dict name -> tensor (chains, draws, *event_shape); with
    ``draw_chunk``, float32 numpy arrays on the host.
    ``info``: TransitionInfo (ChEES: ``ChEESInfo``, endpoint fields of
    width 0) with (chains, draws) tensors; numpy arrays with ``draw_chunk``.
    ``tunables``: adapted step size, inverse mass diagonal and (ChEES)
    trajectory length.
    ``host_syncs``: device-to-host syncs the run made.
    ``graph_replays``: replays of the transition's CUDA graphs (0 where
    the transitions ran eagerly).
    ``leapfrog_counts``: ChEES's leapfrog count of every transition,
    warmup first (empty for the other kernels).
    ``probe_evals``: the step-size probe's evaluations (one value+grad and
    one host read each).
    ``resume_payload``: what a bit-exact continuation needs (the final
    positions, the adaptation state, the run's settings), which
    ``io/checkpoint.py`` saves and ``resume`` continues; None for a
    ``resume_warmup`` result, as in the reference.
    ``device_stats`` (``sample_sharded(device_diagnostics=True)``): split
    R-hat and ESS per flat dimension, computed on the device.
    ``collectives`` (``sample_sharded``): count and milliseconds of the
    collectives of the adaptation, the device diagnostics and the final
    gathers (draws, info and the resume payload's positions and state).
    """

    samples: Dict[str, torch.Tensor]
    info: TransitionInfo
    tunables: Tunables
    num_chains: int
    num_samples: int
    kernel: str = "nuts"
    host_syncs: int = 0
    graph_replays: int = 0
    leapfrog_counts: tuple = ()
    probe_evals: int = 0
    resume_payload: Optional[Dict[str, Any]] = field(default=None, repr=False)
    device_stats: Optional[Dict[str, torch.Tensor]] = None
    collectives: Optional[Dict[str, Dict[str, float]]] = None
    _numpy_cache: Optional[Dict[str, np.ndarray]] = field(default=None, repr=False)

    def to_numpy(self) -> Dict[str, np.ndarray]:
        if self._numpy_cache is None:
            self._numpy_cache = {k: _host(v) for k, v in self.samples.items()}
        return self._numpy_cache

    @property
    def acceptance_rate(self) -> float:
        """Fraction of accepted proposals (metropolis, hmc, chees, mala); for
        NUTS, whose trajectory always moves, the mean Metropolis acceptance
        statistic (Stan's 'accept_stat'), as the reference reports them."""
        if self.kernel == "nuts":
            return _mean(self.info.accept_prob)
        return _mean(self.info.is_accepted)

    @property
    def divergences(self) -> int:
        return int(self.info.is_divergent.sum())

    def flat_samples(self) -> Dict[str, np.ndarray]:
        """(chains*draws, *event) numpy arrays: the reference's output shape
        for single-chain runs."""
        return {k: v.reshape(-1, *v.shape[2:]) for k, v in self.to_numpy().items()}

    def diagnostics(self) -> Dict[str, Dict[str, float]]:
        """Per-parameter split R-hat (max) and effective sample size (min)."""
        out = {}
        for k, v in self.to_numpy().items():
            flat_event = v.reshape(v.shape[0], v.shape[1], -1)
            out[k] = {
                "r_hat": float(np.max(potential_scale_reduction(flat_event))),
                "n_eff": float(np.min(effective_sample_size(flat_event))),
            }
        return out

    def summary(self, credible_interval: float = 0.95) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self.to_numpy().items():
            if v.ndim == 2:
                out[k] = summary_stats(v, credible_interval)
            else:
                flat_event = v.reshape(v.shape[0], v.shape[1], -1)
                for i in range(flat_event.shape[-1]):
                    out[f"{k}[{i}]"] = summary_stats(flat_event[..., i], credible_interval)
        return out


def _host(x) -> np.ndarray:
    """A draw store as a float32 numpy array (bf16 widens exactly)."""
    if isinstance(x, np.ndarray):
        return x
    return x.detach().float().cpu().numpy()


def _mean(x) -> float:
    """The float32 mean of an info field, on the device or the host."""
    if isinstance(x, np.ndarray):
        return float(np.mean(x, dtype=np.float32))
    return float(x.float().mean())


def _as_dtype(store_dtype):
    if store_dtype is None or isinstance(store_dtype, torch.dtype):
        return store_dtype
    dtype = getattr(torch, str(store_dtype), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown store_dtype {store_dtype!r}")
    return dtype


def _first(params):
    """The first entry of every leaf: one chain's parameters of a
    ``batched_initial`` dict."""
    if isinstance(params, dict):
        return {k: _first(v) for k, v in params.items()}
    return torch.as_tensor(params)[0]


_INIT_STRATEGIES = ("tile", "map", "advi")


def sample(
    log_prob_fn: Optional[Callable[..., torch.Tensor]],
    initial_params: Any,
    *,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    num_chains: int = 1,
    kernel: str = "nuts",
    seed: int = 0,
    step_size="auto",
    adapt_step_size: bool = True,
    adapt_mass_matrix: bool = True,
    target_accept: Optional[float] = None,
    jitter: float = 0.0,
    batched_initial: bool = False,
    transforms: Optional[dict] = None,
    config=None,
    data=None,
    init_strategy: str = "tile",
    store_dtype=None,
    draw_chunk: Optional[int] = None,
    max_tree_depth: int = 10,
    num_leapfrog_steps: int = 10,
    max_leapfrog_steps: int = 1000,
    value_and_grad_fn: Optional[Callable] = None,
    thin: int = 1,
    static_schedule: bool = False,
    init_inv_mass_diag=None,
    progress_every: Optional[int] = None,
    progress_callback: Optional[Callable] = None,
    device=None,
) -> MCMCResult:
    """Run multi-chain MCMC against a dict-of-params model.

    ``kernel`` is 'metropolis', 'hmc', 'nuts', 'chees' or 'mala'.
    ``log_prob_fn(params)`` (or ``log_prob_fn(params, data)`` with
    ``data=``) returns a scalar log density. ``value_and_grad_fn(Z, data)``
    replaces autograd with a batched fused implementation; ``log_prob_fn``
    may then be None. Every chain starts at ``initial_params`` (plus
    ``jitter`` times a standard normal of its own, ``engine.jittered_starts``),
    or, with ``batched_initial=True``, at its own entry of the leaves'
    leading ``num_chains`` axis. ``init_strategy='map'`` then moves every
    start by 200 Adam steps up the log density from a jittered point
    (``init_strategies.map_initialize``; the jitter is ``jitter`` or 1);
    ``init_strategy='advi'`` fits a mean-field q by 500 ADVI steps from the
    first chain's start (``vi.advi_initialize``),
    draws every chain's start from q (a draw whose log density is not
    finite keeps its start) and, unless ``init_inv_mass_diag`` is given,
    takes q's variances as the initial metric; 'tile' (the default) keeps
    them. Both climb through ``value_and_grad_fn`` where one is given. ``transforms`` maps parameter names to
    unconstraining transforms (names like 'log'/'logit'/'simplex' or
    ``Transform`` instances): those parameters are sampled in
    unconstrained space with the Jacobian added, and the draws come back
    constrained.

    The step size of a gradient kernel starts from a Stan-style probe
    (``step_size='auto'``) or from the float given (Metropolis: 0.1 for
    'auto'), and adapts with the diagonal mass matrix during warmup toward
    ``target_accept`` (the kernel's default);
    ``adapt_step_size=False`` keeps ``step_size`` and
    ``adapt_mass_matrix=False`` the metric ``init_inv_mass_diag`` (ones).
    ``num_leapfrog_steps`` (hmc), ``max_tree_depth`` and
    ``static_schedule`` (nuts: the reference's fixed-trip pair loop, the
    same draws, no host read inside a transition), ``max_leapfrog_steps``
    (chees), ``thin`` and ``progress_every``/``progress_callback``: see
    ``engine.build_sampler``. ``store_dtype`` (e.g. ``'bfloat16'``)
    down-casts only the stored draws. ``device=None`` means CUDA and raises
    without a GPU; pass ``'cpu'`` to run on the CPU.

    ``config`` (a :class:`mlx_mcmc_tpu_torch.utils.SamplerConfig`) supplies
    the run settings in one object: its fields replace the keyword
    arguments of the same names (and those it leaves out for its kernel
    take their defaults), except that an explicit ``store_dtype`` or
    ``draw_chunk`` wins; the other arguments pass through.

    ``draw_chunk=k`` runs the draws in chunks of ``k`` and fetches each to
    host memory before the next runs, so the whole (chains, draws, D) store
    never sits on the card. Each chunk continues from the last one's final
    positions and adaptation state at its draw offset, so the draws and
    diagnostics are the unchunked run's bits; ``samples`` and ``info`` are
    numpy arrays (a bf16 store comes back widened to float32). A chunk of
    ``num_samples`` or more is the unchunked run.

    Runners are cached (``_RUNNER_CACHE``, see ``clear_runner_cache``): a
    call with the same functions, parameter structure, settings, chain
    count, device and ``data`` tensors replays the graphs of the last one;
    a new seed, new initial values, ``jitter``, initial metric, draw count
    or ``draw_chunk`` reuse them. ``resume_payload`` lets
    ``io.checkpoint.save_checkpoint`` and ``resume`` continue the run
    (from the last chunk, with ``draw_chunk``) bit for bit.
    """
    if config is not None:
        kw = config.to_kwargs()
        # explicit store_dtype and draw_chunk win over the config's
        store_dtype = store_dtype if store_dtype is not None else kw.get("store_dtype")
        draw_chunk = draw_chunk if draw_chunk is not None else kw.get("draw_chunk")
        kw.update(store_dtype=store_dtype, draw_chunk=draw_chunk)
        return sample(
            log_prob_fn, initial_params, batched_initial=batched_initial,
            transforms=transforms, data=data, init_strategy=init_strategy,
            value_and_grad_fn=value_and_grad_fn, static_schedule=static_schedule,
            init_inv_mass_diag=init_inv_mass_diag, progress_every=progress_every,
            progress_callback=progress_callback, device=device, **kw)
    dev = resolve_device(device)
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    if log_prob_fn is None and value_and_grad_fn is None:
        raise ValueError("pass log_prob_fn or value_and_grad_fn")
    if transforms and log_prob_fn is None:
        raise ValueError("transforms rewrite log_prob_fn; pass one")
    if init_strategy not in _INIT_STRATEGIES:
        raise ValueError(f"Unknown init_strategy: {init_strategy!r}")
    if draw_chunk is not None:
        if draw_chunk <= 0:
            raise ValueError(f"draw_chunk must be positive, got {draw_chunk}")
        if draw_chunk >= num_samples:
            draw_chunk = None  # one chunk is the unchunked run
    settings = run_settings(kernel, num_warmup, dict(
        step_size=step_size, adapt_step_size=adapt_step_size,
        adapt_mass_matrix=adapt_mass_matrix, target_accept=target_accept,
        store_dtype=store_dtype, thin=thin, max_tree_depth=max_tree_depth,
        static_schedule=static_schedule, num_leapfrog_steps=num_leapfrog_steps,
        max_leapfrog_steps=max_leapfrog_steps, value_and_grad_fn=value_and_grad_fn,
        progress_every=progress_every, progress_callback=progress_callback))
    # Per-call values: the initial positions, in the sampled space.
    maps = transformed(log_prob_fn, transforms, data)
    if maps[2] is not None:
        initial_params = maps[2](initial_params)
    example = _first(initial_params) if batched_initial else initial_params
    entry = cached_runner(log_prob_fn, example, data=data, transforms=transforms,
                          num_chains=num_chains, device=dev, settings=settings, maps=maps)
    if batched_initial:
        z0_batch = ravel_batched(initial_params, device=dev)
        if z0_batch.shape[0] != num_chains:
            raise ValueError(
                f"batched_initial leaves have leading axis {z0_batch.shape[0]}, "
                f"expected num_chains={num_chains}")
    else:
        z0, _ = ravel_params(initial_params, device=dev)
        z0_batch = z0.expand(num_chains, z0.shape[0]).contiguous()
        if jitter > 0.0:
            z0_batch = jittered_starts(int(seed), z0_batch, jitter)
    if init_strategy == "map":
        z0_batch = map_initialize(batched_vag(entry["flat_log_prob"], data, value_and_grad_fn),
                                  z0_batch, int(seed), jitter=jitter if jitter > 0 else 1.0)
    elif init_strategy == "advi":
        # Starts drawn from a mean-field q fitted from the first chain's,
        # through the fused value+grad where one is given; q's variances
        # as the initial metric unless one was given.
        z0_batch, advi_inv_mass = advi_initialize(
            entry["flat_log_prob"], z0_batch, int(seed), data=data,
            value_and_grad_fn=value_and_grad_fn)
        if init_inv_mass_diag is None:
            init_inv_mass_diag = advi_inv_mass
    run, unravel, to_constrained = entry["run"], entry["unravel"], entry["to_constrained"]

    def post(positions):
        samples = unravel(positions)
        return samples if to_constrained is None else to_constrained(samples)

    results = [run(int(seed), z0_batch, data, num_samples=draw_chunk or num_samples,
                   init_inv_mass_diag=init_inv_mass_diag)]
    if draw_chunk is None:
        samples, info = post(results[0].positions), results[0].info
    else:
        # Fetch every chunk to the host before the next one runs. The
        # continuations run no warmup and take the adaptation state of the
        # run before, through the same runner and graphs.
        parts = [_fetch(post, results[0])]
        for offset in range(draw_chunk, num_samples, draw_chunk):
            last = results[-1]
            results.append(run(int(seed), last.final_state.position, data,
                               resume_state=(last.final_adapt, last.final_traj),
                               sample_start=offset,
                               num_samples=min(draw_chunk, num_samples - offset),
                               warmup_start=num_warmup, warmup_stop=num_warmup))
            parts.append(_fetch(post, results[-1]))
        samples = {k: np.concatenate([p[0][k] for p in parts], axis=1) for k in parts[0][0]}
        info = type(parts[0][1])(*(np.concatenate(fields, axis=1)
                                   for fields in zip(*(p[1] for p in parts))))
    last = results[-1]
    return MCMCResult(
        samples=samples,
        info=info,
        tunables=last.final_tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        host_syncs=sum(r.host_syncs for r in results),
        graph_replays=sum(r.graph_replays for r in results),
        leapfrog_counts=tuple(n for r in results for n in r.leapfrog_counts),
        probe_evals=results[0].probe_evals,
        # on the device until saved
        resume_payload=resume_payload(
            last, unravel, num_warmup=int(num_warmup), num_chains=int(num_chains),
            next_sample_start=int(num_samples), thin=int(thin), kernel=kernel, seed=int(seed),
            step_size=settings["step_size"], adapt_step_size=settings["adapt_step_size"],
            adapt_mass_matrix=settings["adapt_mass_matrix"], target_accept=target_accept,
            store_dtype=dtype_name(settings["store_dtype"]),
            kernel_kwargs=run_kwargs(kernel, settings),
            has_transforms=transforms is not None, data_fingerprint=data_fingerprint(data)),
    )


def _fetch(post, result):
    """A chunk's constrained draws (float32) and info as numpy arrays."""
    samples = {k: _host(v) for k, v in post(result.positions).items()}
    return samples, type(result.info)(*(x.cpu().numpy() for x in result.info))


# Reserved step index of the posterior predictive's per-chain generator
# seeds: no sampling step, the probe's (engine._PROBE_STEP), the jittered
# starts' (engine.JITTER_STEP) or MAP's (init_strategies.MAP_JITTER_STEP).
PREDICTIVE_STEP = 0x7FFFFFFC


def _stack(outs: list):
    """Stack a list of equally structured outputs (tensors in dicts,
    lists and tuples) along a new leading axis."""
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack(list(parts)) for parts in zip(*outs))
    return torch.stack(outs)


def _chain_generator(seed: int, chain: int, device) -> torch.Generator:
    """Chain ``chain``'s posterior-predictive generator on ``device``,
    seeded with the 64-bit Philox word pair at ``(seed, chain,
    PREDICTIVE_STEP)`` (the plain version, read on the host): a chain's
    stream does not depend on how many chains there are."""
    w = words(seed, torch.tensor([chain]), PREDICTIVE_STEP, 1, STREAM_UNIFORM)[0, 0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(w[0]) | (int(w[1]) << 32))
    return gen


def sample_posterior_predictive(
    predictive_fn: Callable[..., Any],
    samples: Dict[str, torch.Tensor],
    seed: int = 0,
    data=None,
    device=None,
) -> Any:
    """Draw from the posterior predictive: run a user predictive function at
    every posterior draw.

    ``predictive_fn(generator, params)`` (``(generator, params, data)``
    with ``data``) returns simulated data (a tensor, or dicts, lists and
    tuples of them), drawing its randomness from the ``torch.Generator`` it
    is given, e.g. ``lambda g, p: Normal(p['mu'], 1.0).sample(g, (n,))``.
    ``samples``: dict of ``(chains, draws, *event)`` posterior draws
    (``MCMCResult.samples``), moved to ``device`` (None means CUDA and
    raises without a GPU).

    Chain ``c`` gets a generator of its own (:func:`_chain_generator`), and
    its draws go through ``predictive_fn`` under ``torch.func.vmap(...,
    randomness="different")``, one call per chain: each draw gets its own
    numbers, and a chain's numbers do not depend on how many chains there
    are (they do depend on its draw count; the reference folds a key per
    (chain, draw)). Returns ``(chains, draws, *sim_shape)`` on the device.
    """
    dev = resolve_device(device)
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    samples = {k: torch.as_tensor(v, device=dev) for k, v in samples.items()}
    num_chains = next(iter(samples.values())).shape[0]
    outs = []
    for c in range(num_chains):
        gen = _chain_generator(int(seed), c, dev)
        if data is None:
            def fn(p, gen=gen):
                return predictive_fn(gen, p)
        else:
            def fn(p, gen=gen):
                return predictive_fn(gen, p, data)
        outs.append(torch.func.vmap(fn, randomness="different")(
            {k: v[c] for k, v in samples.items()}))
    return _stack(outs)
