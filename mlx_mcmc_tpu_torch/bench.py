"""The port's benchmark entries: ``glm100_fused`` and ``glm1000_fused``
(each with the ``funnel8`` detail) and ``poisson1000_cov``.

Counterpart of the repository's ``bench.py`` for these configs, with the
same settings and the same JSON line. Run on the GPU:

    python -m mlx_mcmc_tpu_torch.bench [glm100_fused | glm1000_fused | poisson1000_cov]
    python -m mlx_mcmc_tpu_torch.bench loop    # costs inside the NUTS loop
    python -m mlx_mcmc_tpu_torch.bench paired [CONFIG ...] [--against ROOT] [--no-runs]
        # the kernels of each config's main path at its shape, then its walls
        # and device busy share, beside ROOT's package in turns (default
        # configs glm100_fused and poisson1000_cov)

The timed run follows a warm run (kernel build, allocator and library
start-up are excluded). ESS is computed on the device. The detail adds every
kernel's launch count, the host-sync count of the timed run and the seconds
``build_problem`` took to make the data. Every config samples the
reference's own dataset: ``models/glm.py`` and ``models/poisson.py`` draw
them from the reference's threefry streams (``models/jax_random.py``), key
for key, the Poisson counts through ``jax.random.poisson``'s own algorithm.
``build_problem`` also knows the Gaussian linear regression
(``family="linear"``) that ``chip_smoke.py`` drives through K2, and a GLM
config with ``quantize="int8"`` stores X as the reference's int8 with
per-column scales; the reference's bench has neither config, so neither
has this one.
"""

from __future__ import annotations

import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess_chunked
from mlx_mcmc_tpu_torch.models import (
    eight_schools,
    make_linear_regression,
    make_logistic_regression,
    make_poisson_event_rates,
)
from mlx_mcmc_tpu_torch.ops.glm import (
    fused_hoisted_vag_cuda,
    fused_linear_vag_cuda,
    fused_logistic_vag_cuda,
    make_fused_linear_vag,
    make_fused_logistic_vag,
    prepare_fused_linear_data,
    prepare_fused_logistic_data,
)
from mlx_mcmc_tpu_torch.ops.poisson import (
    fused_poisson_vag_cuda,
    make_fused_poisson_model,
    prepare_fused_poisson_data,
)
from mlx_mcmc_tpu_torch.ops.random import step_draws_cuda

# Every kernel wrapper, by the name of its kernel entry (the hoisted GLM
# kernel is on no sampling path: its count stays 0 in a run).
KERNELS = {
    "glm_fused_logistic": fused_logistic_vag_cuda,
    "glm_fused_linear": fused_linear_vag_cuda,
    "glm_fused_hoisted": fused_hoisted_vag_cuda,
    "poisson_fused": fused_poisson_vag_cuda,
    "philox_step_draws": step_draws_cuda,
}


def reset_launch_counts() -> None:
    for wrapper in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in KERNELS.items()}

CONFIGS = {
    "glm100_fused": dict(
        family="glm", num_features=100, num_obs=10_000, num_chains=4096,
        num_warmup=300, num_samples=2000, max_tree_depth=6,
        target_accept=0.8, store_dtype="bfloat16",
        baseline_ess_per_sec=0.44,
        label=(
            "min-ESS/sec/chip, NUTS 100-param logistic GLM "
            "(10K obs, {chains} chains, bf16 fused CUDA)"
        ),
    ),
    # The reference's wide GLM row (bench.py:105-113, run as at 387-415):
    # D = 1000 takes the kernel's two-kernel wide path; f32 draw store.
    "glm1000_fused": dict(
        family="glm", num_features=1000, num_obs=100_000, num_chains=256,
        num_warmup=400, num_samples=400, max_tree_depth=8,
        target_accept=0.8, store_dtype=None, baseline_ess_per_sec=0.03,
        label=(
            "min-ESS/sec/chip, NUTS 1000-param logistic GLM "
            "(100K obs, {chains} chains, bf16 fused CUDA)"
        ),
    ),
    # The non-collapsible Poisson row (bench.py:164-181): per-count
    # covariates force full-data evaluations, through K3 on every leapfrog.
    "poisson1000_cov": dict(
        family="poisson", num_groups=1000, obs_per_group=100, covariate_dim=4,
        num_chains=512, num_warmup=400, num_samples=400, max_tree_depth=8,
        target_accept=0.9, store_dtype="bfloat16", baseline_ess_per_sec=0.03,
        label=(
            "min-ESS/sec/chip, NUTS 1000-group hierarchical Poisson "
            "regression (100K obs, {chains} chains, fused CUDA)"
        ),
    ),
    # The detail row as the reference's bench runs it next to the GLM.
    "funnel8": dict(
        family="funnel", num_chains=512, num_warmup=400, num_samples=400,
        max_tree_depth=10, target_accept=0.9, store_dtype=None,
        baseline_ess_per_sec=None,
        label="min-ESS/sec/chip, NUTS centered eight-schools funnel ({chains} chains)",
    ),
}


def build_problem(cfg):
    """Return ``(log_prob_fn, initial_params, data, extra_kwargs)``."""
    if cfg["family"] == "glm":
        spec = make_logistic_regression(
            num_features=cfg["num_features"], num_obs=cfg["num_obs"], seed=0,
            data_dtype=torch.bfloat16,
        )
        data = prepare_fused_logistic_data(spec.X, spec.y, quantize=cfg.get("quantize"))
        extra = {"value_and_grad_fn": make_fused_logistic_vag(prior_scale=1.0)}
        return None, spec.initial_params, data, extra
    if cfg["family"] == "linear":
        spec = make_linear_regression(
            num_features=cfg["num_features"], num_obs=cfg["num_obs"], seed=0,
            data_dtype=torch.bfloat16,
        )
        data = prepare_fused_linear_data(spec.X, spec.y)
        extra = {"value_and_grad_fn": make_fused_linear_vag(prior_scale=1.0)}
        return None, spec.initial_params, data, extra
    if cfg["family"] == "poisson":
        spec = make_poisson_event_rates(
            num_groups=cfg["num_groups"], obs_per_group=cfg["obs_per_group"],
            covariate_dim=cfg["covariate_dim"], seed=0,
        )
        data = prepare_fused_poisson_data(spec.y, spec.X)
        log_prob, vag = make_fused_poisson_model()
        return log_prob, spec.initial_params, data, {"value_and_grad_fn": vag}
    if cfg["family"] == "funnel":
        spec = eight_schools(centered=True)
        return spec.log_prob, spec.initial_params, None, {}
    raise ValueError(f"unknown family: {cfg['family']!r}")


def run_config(cfg, seed: int = 1, problem=None):
    """One run of ``cfg`` through ``sample()``, timed to the device ESS.

    Returns ``(metrics, result, ess)``; ``ess`` is the (P,) device ESS."""
    log_prob, initial_params, data, extra = problem or build_problem(cfg)
    launches0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = sample(
        log_prob, initial_params, data=data,
        num_samples=cfg["num_samples"], num_warmup=cfg["num_warmup"],
        num_chains=cfg["num_chains"], kernel="nuts", seed=seed,
        max_tree_depth=cfg["max_tree_depth"], target_accept=cfg["target_accept"],
        store_dtype=cfg["store_dtype"], **extra,
    )
    flat = torch.cat(
        [v.reshape(v.shape[0], v.shape[1], -1) for v in result.samples.values()], dim=-1
    )
    ess = device_ess_chunked(flat).cpu().numpy()
    wall = time.perf_counter() - t0
    draws = cfg["num_chains"] * cfg["num_samples"]
    min_ess = float(np.min(ess))
    names = [
        f"{k}[{i}]" if v.dim() > 2 else k
        for k, v in result.samples.items() for i in range(v[0, 0].numel())
    ]
    metrics = {
        "wall_seconds": wall,
        "min_ess": min_ess,
        "min_ess_param": names[int(np.argmin(ess))],
        "median_ess": float(np.median(ess)),
        "ess_per_sec": min_ess / wall,
        "divergences": result.divergences,
        "divergence_rate": result.divergences / draws,
        "mean_accept": result.acceptance_rate,
        "mean_tree_depth": float(result.info.tree_depth.float().mean()),
        "ess_backend": "device",
        "launches": {k: v - launches0[k] for k, v in launch_counts().items()},
        "host_syncs": result.host_syncs,
    }
    return metrics, result, ess


def _ms_per_call(fn, arg, reps: int = 50) -> float:
    fn(arg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(arg)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def loop_costs() -> dict:
    """Host-clock costs inside the eager NUTS loop, at the funnel's shape
    (512 chains, centered eight schools): one NUTS step's ms per pair
    iteration with a trivial value+grad (the loop body alone) and with the
    generic one, and the generic value+grad per call beside
    ``vmap(grad_and_value)``, the form it replaced."""
    from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
    from mlx_mcmc_tpu_torch.kernels.base import Tunables
    from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
    from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

    spec = eight_schools(centered=True)
    flp, _, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    Z = 0.3 * torch.randn(512, 10, generator=gen, device="cuda")
    generic = make_batched_value_and_grad(flp)
    grad_and_value = torch.func.vmap(torch.func.grad_and_value(flp))
    out = {
        "generic_vag_ms": _ms_per_call(generic, Z),
        "vmap_grad_and_value_ms": _ms_per_call(grad_and_value, Z),
    }
    tun = Tunables(torch.tensor(0.05, device="cuda"), torch.ones(10, device="cuda"))
    r0 = torch.randn(512, 10, generator=gen, device="cuda")
    U = torch.rand(512, 512, 4, generator=gen, device="cuda")
    for name, vag in [("body", lambda z: (-0.5 * (z * z).sum(-1), -z)), ("funnel", generic)]:
        init_fn, step_fn = make_nuts_kernel(vag, max_tree_depth=10)
        state = init_fn(Z)
        step_fn(state, tun, r0, U)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, syncs = step_fn(state, tun, r0, U)
        torch.cuda.synchronize()
        out[f"{name}_ms_per_iteration"] = (time.perf_counter() - t0) / syncs * 1e3
        out[f"{name}_iterations"] = syncs
    return out


def device_ms(fn, reps: int = 7, inner: int = 10, hide_host: bool = True) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events. With ``hide_host`` the stream first sleeps on the card
    (~10 ms, longer than the host takes to enqueue the calls), so the events
    time the device work and not the pace of the Python wrapper; without it
    the time is what a caller that launches and moves on pays per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hide_host:
            torch.cuda._sleep(20_000_000)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _profile_kernels(fn) -> tuple:
    """Runs ``fn`` once under torch.profiler (device activity only).
    Returns (device microseconds of each kernel and copy it ran, summed by
    name, and the wall seconds of ``fn`` up to a synchronize)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
        if us and not ev.key.startswith("cuda"):
            name = ev.key.replace("void ", "").replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + us
    return out, wall


def kernels_ms(fn, calls: int = 10) -> dict:
    """Device ms per call of each CUDA kernel ``fn`` launches, by name, from
    torch.profiler over ``calls`` calls."""
    totals, _ = _profile_kernels(lambda: [fn() for _ in range(calls)])
    return {name: us / 1e3 / calls for name, us in totals.items()}


def _device_busy(run) -> dict:
    """The device's busy share over one call of ``run``: the device time of
    every kernel and copy over the wall. The profiler's own cost per launch
    lengthens the wall, so the share reads a little low."""
    totals, wall = _profile_kernels(run)
    busy = sum(totals.values()) / 1e6
    return {"wall_seconds": wall, "device_seconds": busy, "busy_share": busy / wall}


def _bench_from(root: str):
    """This module as the checkout at ``root`` has it, imported as a module
    tree of its own beside this one (its kernels build under ``root``)."""
    if not (Path(root) / "mlx_mcmc_tpu_torch" / "bench.py").is_file():
        raise FileNotFoundError(f"no mlx_mcmc_tpu_torch package under {root}")

    def ours():
        return [k for k in sys.modules if k.split(".")[0] == "mlx_mcmc_tpu_torch"]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, root)
    try:
        return importlib.import_module("mlx_mcmc_tpu_torch.bench")
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)


# The kernels each config's main path runs, timed by ``paired_times`` at the
# config's shape: (label, wrapper name in this module, family of the data;
# "glm_int8" is the GLM data stored as int8, the scales folded into Z).
PAIRED_KERNELS = {
    "glm100_fused": [("K1", "fused_logistic_vag_cuda", "glm"),
                     ("K2", "fused_linear_vag_cuda", "linear"),
                     ("K4", "fused_hoisted_vag_cuda", "glm"),
                     ("K1_int8", "fused_logistic_vag_cuda", "glm_int8")],
    "glm1000_fused": [("K1", "fused_logistic_vag_cuda", "glm"),
                      ("K1_int8", "fused_logistic_vag_cuda", "glm_int8")],
    "poisson1000_cov": [("K3", "fused_poisson_vag_cuda", "poisson")],
}


def _kernel_call(pkg, wrapper: str, cfg: dict, family: str):
    """One call of ``pkg``'s kernel wrapper at ``cfg``'s shape, on this
    module's data for the config (so every package gets the same inputs)
    and chain positions drawn from a fixed seed: unit scale for glm100 (|s|
    ~ 1, as its posterior gives), 0.05 for glm1000, near the generator's
    scale for the Poisson model."""
    int8 = family == "glm_int8"
    data = build_problem(dict(cfg, family="glm" if int8 else family,
                              quantize="int8" if int8 else None))[2]
    gen = torch.Generator(device="cuda").manual_seed(1)
    fn = getattr(pkg, wrapper)
    if family == "poisson":
        c, g, k = cfg["num_chains"], cfg["num_groups"], cfg["covariate_dim"]
        theta = 1.0 + 0.5 * torch.randn(c, g, generator=gen, device="cuda")
        beta = 0.2 * torch.randn(c, k, generator=gen, device="cuda")
        args = (data["X"], data["y"], data["shat"], data["lamhat"], theta, beta)
        return lambda: fn(*args)
    scale = 0.05 if cfg["num_features"] > 128 else 1.0
    Z = scale * torch.randn(cfg["num_chains"], data["dim"], generator=gen, device="cuda")
    if int8:
        Z = Z * data["col_scale"]
    if wrapper == "fused_hoisted_vag_cuda":
        return lambda: fn(data["Xp"], Z)
    return lambda: fn(data["Xp"], data["yp"], Z)


def paired_times(names, against: str | None = None, runs: bool = True, emit=None) -> dict:
    """For each config in ``names``: device ms per call of each kernel its
    main path runs (``PAIRED_KERNELS``) at its shape, with the host's
    enqueue hidden (``kernel_ms``) and per wrapper call (``call_ms``), and
    the device ms of each CUDA kernel a call launches; with ``runs``, one
    full run of the config (wall to the device ESS, launches, host syncs,
    min-ESS) and the device's busy share over a 20 + 20 run under the
    profiler (``emit(phase, name, results)`` after each phase, so a run cut
    short keeps what it measured). With ``against``, the root of another
    checkout, the same for that checkout's package in this process, in
    turns (other, this, this, other), so both are measured on one card in
    one call. The kernels get this package's inputs; each package samples
    through its own data and value+grad (an older checkout's GLM data came
    from numpy's generator); a short run of each first takes the start-up
    costs out of the timed runs."""
    packages = {"this": sys.modules[__name__]}
    if against:
        packages["other"] = _bench_from(against)
    order = ["other", "this", "this", "other"] if against else ["this", "this"]
    emit = emit or (lambda phase, name, res: None)
    out = {}
    for name in names:
        cfg = CONFIGS[name]
        res = out[name] = {key: {"kernel_ms": {}, "call_ms": {}, "kernels_ms": {}, "runs": []}
                           for key in packages}
        for label, wrapper, family in PAIRED_KERNELS[name]:
            calls = {key: _kernel_call(pkg, wrapper, cfg, family) for key, pkg in packages.items()}
            for key in order:
                res[key]["kernel_ms"].setdefault(label, []).append(device_ms(calls[key]))
            for key in order:
                res[key]["call_ms"].setdefault(label, []).append(
                    device_ms(calls[key], hide_host=False))
            for key in packages:
                res[key]["kernels_ms"][label] = kernels_ms(calls[key])
            del calls
        emit("kernels", name, res)
        if not runs:
            continue
        problems = {key: pkg.build_problem(cfg) for key, pkg in packages.items()}
        for key, pkg in packages.items():
            pkg.run_config(dict(cfg, num_warmup=20, num_samples=20), seed=0, problem=problems[key])
        for key in order:
            metrics, _, _ = packages[key].run_config(cfg, seed=1, problem=problems[key])
            res[key]["runs"].append({k: metrics[k] for k in (
                "wall_seconds", "min_ess", "mean_accept", "mean_tree_depth", "divergences",
                "host_syncs")} | {"launches": metrics["launches"]})
        emit("runs", name, res)
        short = dict(cfg, num_warmup=20, num_samples=20)
        for key, pkg in packages.items():
            res[key]["busy_20_20"] = _device_busy(
                lambda: pkg.run_config(short, seed=2, problem=problems[key]))
        emit("busy", name, res)
        del problems
    return out


def main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "glm100_fused"
    if name == "loop":
        print(json.dumps(dict(loop_costs(), device=torch.cuda.get_device_name(0))))
        return
    if name == "paired":
        args = sys.argv[2:]
        against = args[args.index("--against") + 1] if "--against" in args else None
        runs = "--no-runs" not in args
        names = [a for a in args if a in CONFIGS] or ["glm100_fused", "poisson1000_cov"]
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip()

        def emit(phase, config, res):
            print(json.dumps({"phase": phase, "config": config, "device": smi, **res}), flush=True)

        paired_times(names, against, runs, emit)
        return
    cfg = dict(CONFIGS[name])
    cfg["label"] = cfg["label"].format(chains=cfg["num_chains"])
    t0 = time.perf_counter()
    problem = build_problem(cfg)
    data_seconds = time.perf_counter() - t0
    run_config(cfg, seed=0, problem=problem)  # warm run
    metrics, _, _ = run_config(cfg, seed=1, problem=problem)
    ess_per_sec = metrics.pop("ess_per_sec")
    detail = dict(metrics, data_seconds=data_seconds, device=torch.cuda.get_device_name(0))
    if cfg["family"] == "glm":
        fcfg = CONFIGS["funnel8"]
        fmetrics, _, _ = run_config(fcfg, seed=1)
        detail["funnel_eight_schools"] = fmetrics
    baseline = cfg["baseline_ess_per_sec"]
    print(json.dumps({
        "metric": cfg["label"],
        "value": ess_per_sec,
        "unit": "ess/s",
        "vs_baseline": ess_per_sec / baseline if baseline else None,
        "detail": detail,
    }))


if __name__ == "__main__":
    main()
