"""Functional sampling API: ``sample(...) -> MCMCResult``.

Counterpart of ``mlx_mcmc_tpu/inference/api.py:220-585``: the kernels
'metropolis', 'hmc', 'nuts', 'chees' and 'mala', ``data=``, ``num_chains``,
``seed``, ``jitter``, ``batched_initial``, ``transforms``, ``config``,
``init_strategy`` ('tile', 'map'), the tunables, ``thin``, ``store_dtype``,
``draw_chunk``, the kernel kwargs (``num_leapfrog_steps``,
``max_tree_depth``, ``max_leapfrog_steps``, ``static_schedule``,
``value_and_grad_fn``, ``init_inv_mass_diag``, ``progress_every``,
``progress_callback``) and ``device``. Not yet: ``init_strategy='advi'``
(ROADMAP A.9). Draws stay on the device until numpy is asked for, except
with ``draw_chunk``, which fetches every chunk to the host.

The compiled-runner cache (reference ``api.py:63-140, 331-367``) keeps, per
static configuration, the runner that ``build_sampler`` made and, inside
it, the CUDA graphs of its transition (``inference/graphs.py``), so a
repeated ``sample()`` call replays them instead of capturing them again.
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
    data_key,
    jittered_starts,
    make_batched_value_and_grad,
    resolve_step_size,
)
from mlx_mcmc_tpu_torch.inference.init_strategies import map_initialize
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.ops.ravel import _leaves, make_flat_logprob, ravel_batched, ravel_params

# Compiled-runner cache: repeated ``sample()`` calls with the same static
# configuration reuse the runner and the CUDA graphs it captured, instead
# of capturing them again. As in the reference, functions are keyed by
# identity and the entry pins them, so ids cannot be recycled while cached;
# eviction is LRU. Unlike the reference, whose ``data`` and chain count are
# jit arguments, the graphs bake in the data tensors' addresses and the
# chain count, so both are part of the key (tensors by identity and
# shape). Transform instances are keyed by identity, as the reference keys
# them (by hash), ``init_inv_mass_diag`` by value; ``jitter`` and the
# initial values are per-call values, not keys. Mutating a cached ``data``
# tensor in place needs ``clear_runner_cache()``, as mutating what a cached
# closure captures does in the reference.
_RUNNER_CACHE: "OrderedDict[Any, Any]" = OrderedDict()
_RUNNER_CACHE_MAX = 64


def clear_runner_cache() -> None:
    """Drop every cached runner and its graphs. Call after mutating any
    object that a cached model, value+grad or ``data`` holds."""
    _RUNNER_CACHE.clear()


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
    'tile' (the default) keeps them. ``transforms`` maps parameter names to
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
    a new seed, new initial values or another ``jitter`` reuse them.
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
    if init_strategy == "advi":
        raise NotImplementedError("init_strategy='advi' is not ported yet (ROADMAP A.9)")
    if draw_chunk is not None:
        if draw_chunk <= 0:
            raise ValueError(f"draw_chunk must be positive, got {draw_chunk}")
        if draw_chunk >= num_samples:
            draw_chunk = None  # one chunk is the unchunked run
    store = _as_dtype(store_dtype)
    step_size = resolve_step_size(step_size, kernel, adapt_step_size)
    dkey = data_key(data)
    tkey = None if transforms is None else tuple(sorted(transforms.items(), key=lambda kv: kv[0]))
    mkey = (None if init_inv_mass_diag is None
            else tuple(torch.as_tensor(init_inv_mass_diag).flatten().tolist()))
    cache_key = None if dkey is None else (
        id(log_prob_fn), id(value_and_grad_fn), _param_spec(initial_params), dkey,
        int(num_chains), kernel, int(num_samples), int(num_warmup), int(thin), step_size,
        bool(adapt_step_size), bool(adapt_mass_matrix), target_accept, store,
        int(max_tree_depth), bool(static_schedule), dev, graphs.PAIRS_PER_REPLAY,
        int(num_leapfrog_steps), int(max_leapfrog_steps), draw_chunk, bool(batched_initial),
        tkey, mkey, progress_every, id(progress_callback),
    )
    entry = None if cache_key is None else _lru_get(_RUNNER_CACHE, cache_key)
    if entry is not None:
        lp_fn, to_constrained, to_unconstrained = None, entry["to_constrained"], entry[
            "to_unconstrained"]
    elif transforms:
        lp_fn, to_constrained, to_unconstrained = make_transformed_logprob(
            log_prob_fn, transforms, data_aware=data is not None)
    else:
        lp_fn, to_constrained, to_unconstrained = log_prob_fn, None, None
    # Per-call values: the initial positions, in the sampled space.
    if to_unconstrained is not None:
        initial_params = to_unconstrained(initial_params)
    example = _first(initial_params) if batched_initial else initial_params
    if entry is None:
        flat_log_prob, z_example, unravel = make_flat_logprob(
            lp_fn, example, data_aware=data is not None, device=dev
        )
        common = dict(
            kernel=kernel,
            num_warmup=num_warmup,
            thin=thin,
            step_size=step_size,
            adapt_step_size=adapt_step_size,
            adapt_mass_matrix=adapt_mass_matrix,
            target_accept=target_accept,
            store_dtype=store,
            max_tree_depth=max_tree_depth,
            num_leapfrog_steps=num_leapfrog_steps,
            max_leapfrog_steps=max_leapfrog_steps,
            value_and_grad_fn=value_and_grad_fn,
            static_schedule=static_schedule,
            init_inv_mass_diag=init_inv_mass_diag,
            progress_every=progress_every,
            progress_callback=progress_callback,
        )
        flp = flat_log_prob if log_prob_fn is not None else None
        dim = z_example.shape[0]
        entry = {
            "run": build_sampler(flp, dim, num_samples=draw_chunk or num_samples, **common),
            "flat_log_prob": flp,
            "unravel": unravel,
            "to_constrained": to_constrained,
            "to_unconstrained": to_unconstrained,
            # pin what the key names by id, so no id is recycled while cached
            "pin": (log_prob_fn, value_and_grad_fn, data, tkey, progress_callback),
        }
        if cache_key is not None:
            _lru_put(_RUNNER_CACHE, cache_key, entry, _RUNNER_CACHE_MAX)
    run, unravel = entry["run"], entry["unravel"]
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
        if value_and_grad_fn is not None:
            def map_vag(Z):
                return value_and_grad_fn(Z) if data is None else value_and_grad_fn(Z, data)
        else:
            map_vag = make_batched_value_and_grad(entry["flat_log_prob"], data)
        z0_batch = map_initialize(map_vag, z0_batch, int(seed),
                                  jitter=jitter if jitter > 0 else 1.0)

    def post(positions):
        samples = unravel(positions)
        return samples if to_constrained is None else to_constrained(samples)

    results = [run(int(seed), z0_batch, data)]
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
    return MCMCResult(
        samples=samples,
        info=info,
        tunables=results[-1].final_tunables,
        num_chains=num_chains,
        num_samples=num_samples,
        kernel=kernel,
        host_syncs=sum(r.host_syncs for r in results),
        graph_replays=sum(r.graph_replays for r in results),
        leapfrog_counts=tuple(n for r in results for n in r.leapfrog_counts),
        probe_evals=results[0].probe_evals,
    )


def _fetch(post, result):
    """A chunk's constrained draws (float32) and info as numpy arrays."""
    samples = {k: _host(v) for k, v in post(result.positions).items()}
    return samples, type(result.info)(*(x.cpu().numpy() for x in result.info))
