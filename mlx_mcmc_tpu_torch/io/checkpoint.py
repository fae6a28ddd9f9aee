"""Sampler checkpoint and resume, mid-warmup and mid-sampling.

Counterpart of ``mlx_mcmc_tpu/io/checkpoint.py`` on one device, in its npz
format. Every random input of a run is drawn from Philox keyed on (seed,
chain, global step) and every warmup schedule flag is a function of the
global step (``inference/engine.py``), so a run continued from its final
positions and adaptation state, at its draw offset (:func:`resume`) or at
its warmup step (:func:`run_warmup`, :func:`resume_warmup`), gives the
draws of the uninterrupted run bit for bit. A continuation evaluates its
start once, skips the step-size probe (the adaptation state replaces it)
and replays the CUDA graphs of the run it continues: the runner is found
in ``sample()``'s runner cache (``api.cached_runner``), or built and kept
there once for every later run and continuation with the same settings.

The file is the reference's: one npz holds ``pos_<name>`` (the final
positions, float32, ``(chains, *shape)``; never a bf16 draw store),
``adapt_<i>`` and ``traj_<i>`` (the leaves of ``AdaptationState`` and of
ChEES's ``TrajectoryAdaptState``, in the reference's field order and with
their dtypes), ``inv_mass_diag``, and the JSON meta under
``__mlx_mcmc_tpu_meta__`` with the reference's keys, so each package's
``load_checkpoint`` reads the other's files. The port adds the meta key
``"rng"`` (:data:`RNG`), and ``"callable_kwargs"`` to warmup checkpoints
(the reference records it only for sampling ones). A sampling or warmup
checkpoint without ``"rng"`` was written by the JAX package, whose streams
are threefry: it continues from its positions and adaptation state on this
package's streams, with one warning that the continuation is statistical.
A result without a payload (``resume_warmup``'s, as in the reference) is
saved position-only (the legacy format) and resumes statistically.

Not here: Orbax, which is JAX-only (``backend='orbax'`` raises), and the
sharded paths (``mesh=`` raises, ROADMAP A.10); a sharded checkpoint's meta
names its mesh layout, here always ``"mesh_axes": null``.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.inference.api import (
    TUNABLE_SETTINGS,
    MCMCResult,
    _as_dtype,
    _host,
    cached_runner,
    dtype_name,
    resume_payload,
    run_kwargs,
    run_settings,
    sample,
)
from mlx_mcmc_tpu_torch.inference.engine import data_fingerprint, jittered_starts
from mlx_mcmc_tpu_torch.kernels.adaptation import adaptation_init
from mlx_mcmc_tpu_torch.kernels.chees import trajectory_init
from mlx_mcmc_tpu_torch.ops.ravel import ravel_batched, ravel_params

_META_KEY = "__mlx_mcmc_tpu_meta__"
# The meta key that names this package's streams, and its value.
RNG = "philox4x32-10(seed, chain, step)"


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree_leaves(tree) -> list:
    """The tensors of a tree of named tuples, in field order (the order of
    the reference's ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, tuple):
        return [leaf for node in tree for leaf in _tree_leaves(node)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s tree with its leaves taken in order from ``leaves``."""
    if isinstance(template, tuple):
        nodes = [_unflatten(node, leaves) for node in template]
        return type(template)(*nodes) if hasattr(template, "_fields") else tuple(nodes)
    return next(leaves)


def _no_mesh(where: str, mesh, ckpt=None) -> None:
    """Sharded runs (``mesh=``, or a checkpoint that names its mesh layout)
    wait for ROADMAP A.10."""
    if mesh is not None:
        raise NotImplementedError(f"{where}(mesh=...): sharded runs are not ported yet "
                                  "(ROADMAP A.10)")
    if ckpt is not None and ckpt.get("mesh_axes") is not None:
        raise NotImplementedError(f"{where}: a sharded run's checkpoint (mesh_axes "
                                  f"{ckpt['mesh_axes']}) needs the sharded paths, not ported "
                                  "yet (ROADMAP A.10)")


def _result_state(result) -> Dict[str, Any]:
    """The legacy position-only state of a result: its last stored draws
    (float32) and its tunables."""
    return {
        "positions": {k: _host(v)[:, -1] for k, v in result.samples.items()},
        "step_size": float(result.tunables.step_size),
        "inv_mass_diag": _numpy(result.tunables.inv_mass_diag),
        "kernel": result.kernel,
        "num_chains": result.num_chains,
        "draws_completed": result.num_samples,
    }


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise ValueError("backend='orbax' needs Orbax, which is JAX-only: the port writes npz "
                         "(backend='npz' or 'auto')")
    if backend not in ("auto", "npz"):
        raise ValueError(f"unknown checkpoint backend {backend!r}; the port writes npz")


def save_checkpoint(path: str, result, backend: str = "auto") -> None:
    """Save an :class:`MCMCResult` or a :func:`run_warmup` dict as a
    resumable npz checkpoint (``.npz`` is appended to ``path`` where it is
    missing).

    A result with a ``resume_payload`` (every ``sample()`` result) is saved
    as a bit-exact sampling checkpoint: :func:`resume` continues it draw
    for draw as one longer run. A result without one (``resume_warmup``'s)
    is saved in the legacy position-only format (a statistical resume).
    ``backend``: 'npz' or 'auto' (npz); 'orbax' raises (JAX-only).
    """
    _check_backend(backend)
    if isinstance(result, dict) and result.get("phase") == "warmup":
        _write_ckpt(path, *_warmup_payload(result))
        return
    payload = getattr(result, "resume_payload", None)
    if payload is not None:
        _write_ckpt(path, *_sampling_payload(payload))
        return
    state = _result_state(result)
    meta = {
        "kernel": state["kernel"],
        "num_chains": state["num_chains"],
        "draws_completed": state["draws_completed"],
        "step_size": state["step_size"],
        "param_names": list(state["positions"].keys()),
    }
    arrays = {f"pos_{k}": v for k, v in state["positions"].items()}
    arrays["inv_mass_diag"] = state["inv_mass_diag"]
    _write_ckpt(path, meta, arrays)


def _warmup_payload(ckpt: Dict[str, Any]):
    """(meta, arrays) for a mid-warmup checkpoint dict."""
    meta = {k: ckpt[k] for k in ("phase", "warmup_step", "num_warmup", "num_chains", "kernel",
                                 "seed", "dim")}
    meta["sampler_kwargs"] = ckpt.get("sampler_kwargs", {})
    meta["callable_kwargs"] = list(ckpt.get("callable_kwargs", []))
    meta["data_fingerprint"] = ckpt.get("data_fingerprint")
    meta["mesh_axes"] = ckpt.get("mesh_axes")
    meta["param_names"] = list(ckpt["positions"].keys())
    meta["n_adapt"] = len(ckpt["adapt_leaves"])
    meta["n_traj"] = len(ckpt["traj_leaves"])
    if ckpt.get("rng") is not None:
        meta["rng"] = ckpt["rng"]
    arrays = {f"pos_{k}": _numpy(v) for k, v in ckpt["positions"].items()}
    arrays.update({f"adapt_{i}": _numpy(x) for i, x in enumerate(ckpt["adapt_leaves"])})
    arrays.update({f"traj_{i}": _numpy(x) for i, x in enumerate(ckpt["traj_leaves"])})
    return meta, arrays


def _storable_kwargs(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """The JSON-serializable sampler kwargs (callables must be passed again
    on resume, so that a resume cannot run with other tunables)."""
    return {k: v for k, v in kwargs.items() if isinstance(v, (bool, int, float, str)) or v is None}


def _callable_names(kwargs: Dict[str, Any]) -> list:
    return sorted(k for k, v in kwargs.items() if callable(v))


def _sampling_payload(payload: Dict[str, Any]):
    """(meta, arrays) for a bit-exact sampling checkpoint from an
    ``MCMCResult.resume_payload``."""
    positions = payload["unravel"](payload["flat_position"])
    meta = {k: payload[k] for k in (
        "phase", "num_warmup", "num_chains", "next_sample_start", "thin", "kernel", "seed", "dim",
        "step_size", "adapt_step_size", "adapt_mass_matrix", "target_accept", "store_dtype")}
    meta.update(
        sampler_kwargs=_storable_kwargs(payload["kernel_kwargs"]),
        # Callables (a fused value_and_grad_fn) cannot be saved; their
        # names make resume demand them, since rebuilding with autograd
        # would change the arithmetic without an error.
        callable_kwargs=_callable_names(payload["kernel_kwargs"]),
        has_transforms=payload["has_transforms"],
        data_fingerprint=payload["data_fingerprint"],
        mesh_axes=None,
        has_log_prior=False,
        has_data_specs=False,
        param_names=list(positions.keys()),
        rng=RNG,
    )
    adapt_leaves = _tree_leaves(payload["adapt"])
    traj_leaves = _tree_leaves(payload["traj"])
    meta["n_adapt"] = len(adapt_leaves)
    meta["n_traj"] = len(traj_leaves)
    arrays = {f"pos_{k}": _numpy(v) for k, v in positions.items()}
    arrays.update({f"adapt_{i}": _numpy(x) for i, x in enumerate(adapt_leaves)})
    arrays.update({f"traj_{i}": _numpy(x) for i, x in enumerate(traj_leaves)})
    # a copy of the metric inside the adaptation state, for tooling
    arrays["inv_mass_diag"] = _numpy(payload["inv_mass_diag"])
    return meta, arrays


def _write_ckpt(path: str, meta: dict, arrays: dict) -> None:
    if not path.endswith(".npz"):
        path = path + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **arrays, **{_META_KEY: json.dumps(meta)})


def _load_warmup_npz(data, meta) -> Dict[str, Any]:
    return {
        "phase": "warmup",
        "warmup_step": int(meta["warmup_step"]),
        "num_warmup": int(meta["num_warmup"]),
        "num_chains": int(meta["num_chains"]),
        "kernel": meta["kernel"],
        "seed": int(meta["seed"]),
        "dim": int(meta["dim"]),
        "sampler_kwargs": meta.get("sampler_kwargs", {}),
        "callable_kwargs": meta.get("callable_kwargs", []),
        "data_fingerprint": meta.get("data_fingerprint"),
        "mesh_axes": meta.get("mesh_axes"),
        "rng": meta.get("rng"),
        "positions": {k: data[f"pos_{k}"] for k in meta["param_names"]},
        "adapt_leaves": [data[f"adapt_{i}"] for i in range(meta["n_adapt"])],
        "traj_leaves": [data[f"traj_{i}"] for i in range(meta["n_traj"])],
    }


def _load_sampling(data, meta) -> Dict[str, Any]:
    """A bit-exact sampling checkpoint from its npz entries (or arrays)."""
    out = dict(meta)
    out["positions"] = {k: data[f"pos_{k}"] for k in meta["param_names"]}
    out["adapt_leaves"] = [data[f"adapt_{i}"] for i in range(meta["n_adapt"])]
    out["traj_leaves"] = [data[f"traj_{i}"] for i in range(meta["n_traj"])]
    if "inv_mass_diag" in data:
        out["inv_mass_diag"] = data["inv_mass_diag"]
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint saved by :func:`save_checkpoint` (by this package
    or the JAX package's npz backend)."""
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory (an Orbax checkpoint, JAX-only); the port reads "
                         "npz files")
    if not path.endswith(".npz") and not os.path.exists(path):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data[_META_KEY]))
        if meta.get("phase") == "warmup":
            return _load_warmup_npz(data, meta)
        if meta.get("phase") == "sampling":
            return _load_sampling(data, meta)
        return {
            "positions": {k: data[f"pos_{k}"] for k in meta["param_names"]},
            "step_size": meta["step_size"],
            "inv_mass_diag": data["inv_mass_diag"],
            "kernel": meta["kernel"],
            "num_chains": meta["num_chains"],
            "draws_completed": meta["draws_completed"],
        }


def _warn_if_foreign(ckpt, where: str) -> None:
    if ckpt.get("rng") != RNG:
        warnings.warn(
            f"{where}: the checkpoint names no Philox stream, so the JAX package wrote it (on "
            "threefry streams). It continues from its positions and adaptation state on this "
            "package's streams: a statistical continuation, not the JAX run's draws.",
            stacklevel=3)


def resume(
    log_prob_fn,
    checkpoint,
    *,
    num_samples: int = 1000,
    seed: Optional[int] = None,
    data=None,
    transforms=None,
    mesh=None,
    device=None,
    **kwargs,
) -> MCMCResult:
    """Continue sampling from a checkpoint (a dict, a path, or an
    :class:`MCMCResult` still in memory).

    A sampling checkpoint (a ``sample()`` result, saved or live) continues
    at its draw offset on its own streams: the draws equal draws ``[offset,
    offset + num_samples)`` of one uninterrupted longer run, bit for bit.
    ``seed`` is ignored for it (with a warning); ``data``, ``transforms``
    and any callable kwarg (a fused ``value_and_grad_fn``) must be the
    original call's, and a sampler kwarg may not contradict the stored one.
    One written by the JAX package continues statistically, with a
    warning. A legacy position-only checkpoint resumes with its tunables
    on a fresh stream (``seed``, by default the draws completed + 1); extra
    kwargs go to :func:`sample`. ``device=None`` means CUDA and raises
    without a GPU; pass ``'cpu'`` for the CPU.
    """
    _no_mesh("resume", mesh)
    dev = resolve_device(device)
    if hasattr(checkpoint, "resume_payload"):
        if checkpoint.resume_payload is not None:
            # A live result: through the file's payload helpers, without the
            # disk.
            meta, arrays = _sampling_payload(checkpoint.resume_payload)
            checkpoint = _load_sampling(arrays, meta)
        else:
            checkpoint = _result_state(checkpoint)
    if isinstance(checkpoint, str):
        checkpoint = load_checkpoint(checkpoint)
    if checkpoint.get("phase") == "sampling":
        if seed is not None:
            warnings.warn(
                "resume: `seed` is ignored for a bit-exact sampling checkpoint: the continuation "
                f"always uses the checkpointed run's stream (seed={checkpoint['seed']}). For an "
                "independent continuation, resume a legacy position-only checkpoint.",
                stacklevel=2)
        _no_mesh("resume", None, checkpoint)
        return _resume_exact(log_prob_fn, checkpoint, num_samples=num_samples, data=data,
                             transforms=transforms, device=dev, **kwargs)
    if checkpoint.get("phase") == "warmup":
        raise ValueError("resume() got a mid-warmup checkpoint; use resume_warmup()")
    if seed is None:
        # continue the stream deterministically past the completed draws
        seed = int(checkpoint["draws_completed"]) + 1
    start = {k: torch.tensor(v) for k, v in checkpoint["positions"].items()}
    return sample(
        log_prob_fn, start, num_samples=num_samples, num_warmup=0,
        num_chains=checkpoint["num_chains"], kernel=checkpoint["kernel"], seed=seed,
        step_size=float(checkpoint["step_size"]), adapt_step_size=False,
        adapt_mass_matrix=False, init_inv_mass_diag=torch.tensor(checkpoint["inv_mass_diag"]),
        batched_initial=True, data=data, transforms=transforms, device=dev, **kwargs)


def _check_stored_kwargs(where: str, ckpt, kwargs) -> None:
    """Re-apply the checkpoint's sampler kwargs to ``kwargs`` (in place):
    a contradicting value, or a callable kwarg the run used and the caller
    did not pass again, raises, since either would silently end the
    bit-exactness."""
    stored = dict(ckpt.get("sampler_kwargs") or {})
    stored.pop("jitter", None)  # the positions are jittered already
    for k, v in stored.items():
        if k in kwargs and kwargs[k] != v:
            raise ValueError(
                f"{where}: kwarg {k}={kwargs[k]!r} contradicts the checkpointed run's {k}={v!r}; "
                "resuming with different sampler settings is not bit-exact")
        kwargs.setdefault(k, v)
    missing = [k for k in ckpt.get("callable_kwargs", []) if k not in kwargs]
    if missing:
        raise ValueError(
            f"{where}: the checkpointed run used callable kwarg(s) {missing} (e.g. a fused "
            "value_and_grad_fn) that cannot be serialized: re-pass the same callable(s) to "
            "resume bit-exactly (rebuilding with autograd would silently change the arithmetic)")


def _check_fingerprint(where: str, ckpt, data):
    """The data's fingerprint, which must equal the checkpoint's: both ways,
    so data given where the run had none, or none where it had some,
    raises too. Returns it."""
    stored = ckpt.get("data_fingerprint")
    stored = None if stored is None else [list(e) for e in stored]
    fp = data_fingerprint(data)
    if fp != stored:
        raise ValueError(
            f"{where}: the provided `data` pytree does not match the checkpointed run's data "
            f"(structure/shape/dtype fingerprint differs):\n  checkpoint: {stored}\n"
            f"  provided:   {fp}")
    return fp


def _validate_exact_resume(ckpt, kwargs, transforms, data):
    """The guards of a bit-exact sampling continuation: transforms, stored
    kwargs (re-applied to ``kwargs`` in place), thin, callables and the data
    fingerprint. Returns ``(thin, fingerprint)``."""
    if bool(ckpt.get("has_transforms")) != (transforms is not None):
        raise ValueError(
            "resume: the checkpointed run "
            + ("used" if ckpt.get("has_transforms") else "did not use")
            + " `transforms`; pass the same transforms dict to resume bit-exactly")
    _check_stored_kwargs("resume", ckpt, kwargs)
    thin = int(ckpt.get("thin", 1))
    if kwargs.get("thin", thin) != thin:
        raise ValueError(f"resume: thin={kwargs['thin']} contradicts the checkpointed run's "
                         f"thin={thin}")
    kwargs["thin"] = thin
    return thin, _check_fingerprint("resume", ckpt, data)


def _segment_runner(where: str, log_prob_fn, example, *, kernel: str, num_warmup: int,
                    num_chains: int, data, transforms, device, kwargs) -> dict:
    """The runner-cache entry a segment runs on (``api.cached_runner``: the
    run's own, with its graphs, where it is still cached), built from
    ``kwargs`` (``api.run_settings``; an unknown kwarg raises)."""
    try:
        settings = run_settings(kernel, num_warmup, kwargs)
    except ValueError as err:
        raise ValueError(f"{where}: {err}") from None
    return cached_runner(log_prob_fn, example, data=data, transforms=transforms,
                         num_chains=num_chains, device=device, settings=settings)


def _resume_state_from_ckpt(ckpt, device=None):
    """``(AdaptationState, TrajectoryAdaptState or ())`` on ``device`` from
    the checkpoint's leaves, by the reference's leaf order."""
    adapt_t = adaptation_init(int(ckpt["dim"]), 0.1)
    traj_t = trajectory_init(0.1) if ckpt["kernel"] == "chees" else ()
    out = []
    for template, leaves in ((adapt_t, ckpt["adapt_leaves"]), (traj_t, ckpt["traj_leaves"])):
        if len(leaves) != len(_tree_leaves(template)):
            raise ValueError(f"the checkpoint has {len(leaves)} leaves where "
                             f"{type(template).__name__} has {len(_tree_leaves(template))}")
        out.append(_unflatten(template, iter(torch.tensor(x, device=device) for x in leaves)))
    return tuple(out)


def _positions(ckpt, device):
    """The checkpoint's positions on ``device``: ``(example, (C, D) batch)``."""
    positions = {k: torch.tensor(v, device=device) for k, v in ckpt["positions"].items()}
    return {k: v[0] for k, v in positions.items()}, ravel_batched(positions, device=device)


def _resume_exact(log_prob_fn, ckpt, *, num_samples: int, data, transforms, device, **kwargs):
    """Bit-exact sampling continuation: the run's runner with an empty
    warmup segment, drawing ``[offset, offset + num_samples)`` of the
    original global step stream."""
    given = [k for k in TUNABLE_SETTINGS if k in kwargs]
    if given:
        raise ValueError(f"resume: {given} come from the checkpoint; do not pass them")
    thin, fp = _validate_exact_resume(ckpt, kwargs, transforms, data)
    _warn_if_foreign(ckpt, "resume")
    kernel, num_warmup, num_chains = ckpt["kernel"], int(ckpt["num_warmup"]), int(ckpt["num_chains"])
    example, z0_batch = _positions(ckpt, device)
    entry = _segment_runner(
        "resume", log_prob_fn, example, kernel=kernel, num_warmup=num_warmup,
        num_chains=num_chains, data=data, transforms=transforms, device=device,
        kwargs=dict(kwargs, **{k: ckpt[k] for k in TUNABLE_SETTINGS if k != "store_dtype"},
                    store_dtype=ckpt.get("store_dtype")))
    offset = int(ckpt["next_sample_start"])
    result = entry["run"](int(ckpt["seed"]), z0_batch, data, _resume_state_from_ckpt(ckpt, device),
                          offset, num_samples=num_samples, warmup_start=num_warmup,
                          warmup_stop=num_warmup)
    samples = entry["unravel"](result.positions)
    if entry["to_constrained"] is not None:
        samples = entry["to_constrained"](samples)
    payload = resume_payload(
        result, entry["unravel"], num_warmup=num_warmup, num_chains=num_chains,
        next_sample_start=offset + num_samples, thin=thin, kernel=kernel, seed=int(ckpt["seed"]),
        step_size=ckpt["step_size"], adapt_step_size=bool(ckpt["adapt_step_size"]),
        adapt_mass_matrix=bool(ckpt["adapt_mass_matrix"]), target_accept=ckpt["target_accept"],
        store_dtype=ckpt.get("store_dtype"), kernel_kwargs=run_kwargs(kernel, kwargs),
        has_transforms=transforms is not None, data_fingerprint=fp)
    return _result(result, samples, num_chains, num_samples, kernel, payload)


def _result(result, samples, num_chains, num_samples, kernel, payload=None) -> MCMCResult:
    return MCMCResult(
        samples=samples, info=result.info, tunables=result.final_tunables,
        num_chains=num_chains, num_samples=num_samples, kernel=kernel,
        host_syncs=result.host_syncs, graph_replays=result.graph_replays,
        leapfrog_counts=result.leapfrog_counts, probe_evals=result.probe_evals,
        resume_payload=payload)


def _warmup_ckpt_dict(result, unravel, *, step, num_warmup, num_chains, kernel, seed,
                      sampler_kwargs, callable_kwargs, data_fingerprint) -> Dict[str, Any]:
    """A mid-warmup checkpoint dict (the reference's keys, plus
    ``callable_kwargs``, ``rng`` and, in memory only, the segment's
    ``host_syncs`` and ``probe_evals``)."""
    return {
        "phase": "warmup",
        "warmup_step": int(step),
        "num_warmup": int(num_warmup),
        "num_chains": int(num_chains),
        "kernel": kernel,
        "seed": int(seed),
        "dim": int(result.final_state.position.shape[1]),
        "sampler_kwargs": dict(sampler_kwargs or {}),
        "callable_kwargs": list(callable_kwargs),
        "data_fingerprint": data_fingerprint,
        "mesh_axes": None,
        "rng": RNG,
        # (chains, *event) per parameter: the structure a resume rebuilds
        "positions": {k: _numpy(v) for k, v in unravel(result.final_state.position).items()},
        "adapt_leaves": [_numpy(x) for x in _tree_leaves(result.final_adapt)],
        "traj_leaves": [_numpy(x) for x in _tree_leaves(result.final_traj)],
        "host_syncs": result.host_syncs,
        "probe_evals": result.probe_evals,
    }


def run_warmup(
    log_prob_fn,
    initial_params,
    *,
    num_warmup: int = 1000,
    stop: int,
    num_chains: int = 1,
    kernel: str = "nuts",
    seed: int = 0,
    data=None,
    jitter: float = 0.0,
    mesh=None,
    device=None,
    **kwargs,
) -> Dict[str, Any]:
    """Run the segment ``[0, stop)`` of a ``num_warmup``-step warmup and
    return a mid-warmup checkpoint dict (save it with
    :func:`save_checkpoint`, continue it with :func:`resume_warmup`).

    The other kwargs are :func:`sample`'s sampler settings
    (``target_accept``, ``adapt_*``, ``store_dtype``, the kernel kwargs,
    ``value_and_grad_fn``); the eventual draws equal ``sample(...,
    num_warmup=num_warmup, seed=seed)``'s bit for bit. ``log_prob_fn`` may
    be None with a ``value_and_grad_fn``. ``device=None`` means CUDA and
    raises without a GPU.
    """
    _no_mesh("run_warmup", mesh)
    if not 0 < stop <= num_warmup:
        raise ValueError(f"stop must be in (0, {num_warmup}], got {stop}")
    if not isinstance(seed, (int, np.integer)):
        raise TypeError("run_warmup requires an int seed (it is recorded to rebuild the "
                        f"streams), got {type(seed).__name__}")
    dev = resolve_device(device)
    if kwargs.get("store_dtype") is not None:  # recorded by name
        kwargs["store_dtype"] = dtype_name(_as_dtype(kwargs["store_dtype"]))
    entry = _segment_runner("run_warmup", log_prob_fn, initial_params, kernel=kernel,
                            num_warmup=num_warmup, num_chains=num_chains, data=data,
                            transforms=None, device=dev, kwargs=kwargs)
    # the chains' starts as sample() makes them
    z0, _ = ravel_params(initial_params, device=dev)
    z0_batch = z0.expand(num_chains, z0.shape[0]).contiguous()
    if jitter > 0.0:
        z0_batch = jittered_starts(int(seed), z0_batch, jitter)
    result = entry["run"](int(seed), z0_batch, data, None, 0, num_samples=0, warmup_start=0,
                          warmup_stop=stop, init_inv_mass_diag=kwargs.get("init_inv_mass_diag"))
    return _warmup_ckpt_dict(
        result, entry["unravel"], step=stop, num_warmup=num_warmup, num_chains=num_chains,
        kernel=kernel, seed=seed, sampler_kwargs=dict(_storable_kwargs(kwargs), jitter=jitter),
        callable_kwargs=_callable_names(kwargs), data_fingerprint=data_fingerprint(data))


def resume_warmup(
    log_prob_fn,
    checkpoint,
    *,
    num_samples: int = 1000,
    stop: Optional[int] = None,
    data=None,
    mesh=None,
    device=None,
    **kwargs,
):
    """Continue from a mid-warmup checkpoint (a dict or a path).

    With ``stop`` (< num_warmup): run warmup ``[step, stop)`` and return an
    updated checkpoint dict (segments chain). Without it: finish warmup,
    draw ``num_samples`` and return the :class:`MCMCResult` of the
    uninterrupted run, bit for bit (with no ``resume_payload``, as in the
    reference). The checkpoint's sampler kwargs are re-applied; a
    contradicting kwarg, a missing callable kwarg (a fused
    ``value_and_grad_fn``) or other ``data`` than the run's (either way)
    raises. A checkpoint of the JAX package continues statistically, with a
    warning. ``device=None`` means CUDA and raises without a GPU.
    """
    _no_mesh("resume_warmup", mesh)
    dev = resolve_device(device)
    if isinstance(checkpoint, str):
        checkpoint = load_checkpoint(checkpoint)
    if checkpoint.get("phase") != "warmup":
        raise ValueError("resume_warmup needs a mid-warmup checkpoint (run_warmup); for "
                         "post-warmup checkpoints use resume()")
    _no_mesh("resume_warmup", None, checkpoint)
    start = int(checkpoint["warmup_step"])
    num_warmup = int(checkpoint["num_warmup"])
    kernel, num_chains, seed = checkpoint["kernel"], int(checkpoint["num_chains"]), \
        int(checkpoint["seed"])
    partial = stop is not None and stop < num_warmup
    if stop is not None and not start < stop <= num_warmup:
        raise ValueError(f"stop must be in ({start}, {num_warmup}], got {stop}")
    _check_stored_kwargs("resume_warmup", checkpoint, kwargs)
    fp = _check_fingerprint("resume_warmup", checkpoint, data)
    _warn_if_foreign(checkpoint, "resume_warmup")
    example, z0_batch = _positions(checkpoint, dev)
    entry = _segment_runner("resume_warmup", log_prob_fn, example, kernel=kernel,
                            num_warmup=num_warmup, num_chains=num_chains, data=data,
                            transforms=None, device=dev, kwargs=kwargs)
    result = entry["run"](seed, z0_batch, data, _resume_state_from_ckpt(checkpoint, dev), 0,
                          num_samples=0 if partial else num_samples, warmup_start=start,
                          warmup_stop=stop if partial else num_warmup)
    if partial:
        return _warmup_ckpt_dict(
            result, entry["unravel"], step=stop, num_warmup=num_warmup, num_chains=num_chains,
            kernel=kernel, seed=seed, sampler_kwargs=checkpoint.get("sampler_kwargs"),
            callable_kwargs=_callable_names(kwargs), data_fingerprint=fp)
    return _result(result, entry["unravel"](result.positions), num_chains, num_samples, kernel)
