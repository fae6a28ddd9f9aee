"""The port's benchmark entries: the reference's nine bench configs.

Counterpart of the repository's ``bench.py``, with the same configs, the
same settings, the same environment overrides and the same JSON line. Run
on the GPU:

    python -m mlx_mcmc_tpu_torch.bench [CONFIG]
        # glm100_fused (default), glm100, glm1000, glm1000_fused, hier1000,
        # hier1000_full, poisson1000, poisson1000_cov or funnel8; the GLM
        # configs add the funnel detail row (FUNNEL_DETAIL)
    python -m mlx_mcmc_tpu_torch.bench loop    # costs inside the NUTS loop
    python -m mlx_mcmc_tpu_torch.bench ksweep [CONFIG ...]
        # full runs (warm, then timed) at each pair-iteration count per
        # graph replay, graphs.PAIRS_PER_REPLAY = 1, 2, 4, 8 (default
        # configs glm100_fused, glm1000_fused and poisson1000_cov)
    python -m mlx_mcmc_tpu_torch.bench paired [CONFIG ...] [--against ROOT] [--no-runs]
            [--no-kernels]
        # the kernels of each config's main path at its shape, then its walls
        # and device busy share, beside ROOT's package in turns (default
        # configs glm100_fused and poisson1000_cov)

As in the reference, ``BENCH_CONFIG`` (or the first argument) names the
config and ``BENCH_CHAINS``, ``BENCH_SAMPLES``, ``BENCH_WARMUP`` and
``BENCH_DEPTH`` override its chain count, draws, warmup steps and depth
cap, ``BENCH_THIN`` its thinning; ``BENCH_SKIP_FUNNEL`` drops the funnel
detail row. The line's value is
rounded to 2 places and ``vs_baseline`` to 1, the detail's statistics as
the reference rounds them.

The timed run follows a warm run (kernel build, allocator and library
start-up are excluded; so is the capture of the transition's CUDA graphs,
which the runner cache keeps from the warm run). ESS is computed on the
device. The detail adds the adapted step size, every kernel's launch count,
the host-sync count and the graph replays of the timed run, the pair
iterations per replay and the seconds ``build_problem`` took to make the
data; a GLM config's adds the reference's ``roofline`` block
(:func:`roofline_detail`: useful leapfrogs, achieved TFLOP/s and MFU
against the card's peak for X's dtype, the lockstep tax). Every config samples the
reference's own dataset: ``models/glm.py``, ``models/hierarchical.py`` and
``models/poisson.py`` draw them from the reference's threefry streams
(``models/jax_random.py``), key for key, the Poisson counts through
``jax.random.poisson``'s own algorithm.

The configs' value+grads: the fused GLM and Poisson-regression kernels
(``*_fused``, ``poisson1000_cov``), the closed-form sufficient-statistic
collapse (``hier1000``, ``poisson1000``: ``ops/suffstats.py``), and
autograd of a data-aware model (``glm100``, ``glm1000``: f32 X;
``hier1000_full``: the full 998 x 100 observations; ``funnel8``). Every one
declares ``graph_safe``, so every config samples through CUDA graphs.
``build_problem`` also knows the Gaussian linear regression
(``family="linear"``) that ``chip_smoke.py`` drives through K2; a GLM
config with ``quantize="int8"`` stores X as the reference's int8 with
per-column scales, and a fused one with ``x_dtype="float32"`` keeps the
reference's X in float32 (the recipe's draws before the bf16 cast); the
reference's bench has none of these configs, so neither has this one.
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.benchmarks import elapsed_ms
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess_chunked
from mlx_mcmc_tpu_torch.distributions import Normal
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.models import (
    eight_schools,
    make_hierarchical_normal,
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
from mlx_mcmc_tpu_torch.ops.suffstats import (
    hier_suffstat_log_prob,
    make_hier_normal_vag,
    make_poisson_rates_model,
    prepare_hier_normal_data,
    prepare_poisson_rates_data,
)
from mlx_mcmc_tpu_torch.utils.roofline import glm_vag_bytes, glm_vag_flops, roofline_report

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

# The reference's configs (bench.py:41-193), setting for setting; labels
# say "CUDA" where the reference's say "Pallas". ``target_accept`` is the
# reference's default (0.8) where its config names none.
CONFIGS = {
    # Plain autograd over f32 X: the reference's fair comparison for the
    # fused kernel.
    "glm100": dict(
        family="glm", num_features=100, num_obs=10_000, num_chains=4096,
        num_warmup=500, num_samples=500, max_tree_depth=8, target_accept=0.8,
        store_dtype=None, baseline_ess_per_sec=0.44, fused=False,
        label="min-ESS/sec/chip, NUTS 100-param logistic GLM (10K obs, {chains} chains)",
    ),
    "glm100_fused": dict(
        family="glm", num_features=100, num_obs=10_000, num_chains=4096,
        num_warmup=300, num_samples=2000, max_tree_depth=6,
        target_accept=0.8, store_dtype="bfloat16",
        baseline_ess_per_sec=0.44, fused=True,
        label=(
            "min-ESS/sec/chip, NUTS 100-param logistic GLM "
            "(10K obs, {chains} chains, bf16 fused CUDA)"
        ),
    ),
    "glm1000": dict(
        family="glm", num_features=1000, num_obs=100_000, num_chains=16,
        num_warmup=400, num_samples=400, max_tree_depth=8, target_accept=0.8,
        store_dtype=None, baseline_ess_per_sec=0.03, fused=False,
        label="min-ESS/sec/chip, NUTS 1000-param logistic GLM (100K obs, 16 chains)",
    ),
    # D = 1000 takes the kernel's two-kernel wide path; f32 draw store.
    "glm1000_fused": dict(
        family="glm", num_features=1000, num_obs=100_000, num_chains=256,
        num_warmup=400, num_samples=400, max_tree_depth=8,
        target_accept=0.8, store_dtype=None, baseline_ess_per_sec=0.03, fused=True,
        label=(
            "min-ESS/sec/chip, NUTS 1000-param logistic GLM "
            "(100K obs, {chains} chains, bf16 fused CUDA)"
        ),
    ),
    # The 1000-parameter non-centered hierarchical normal (mu, log_tau and
    # 998 group effects, 99.8K observations): the Gaussian likelihood
    # collapses exactly to per-group means (ops/suffstats.py), so a leapfrog
    # is O(chains x G) elementwise work; hier1000_full keeps the full data.
    # The chain counts are the reference's, sized to a TPU v5e's memory.
    "hier1000": dict(
        family="hier", num_groups=998, obs_per_group=100, suffstats=True,
        num_chains=512, num_warmup=400, num_samples=1000, max_tree_depth=10,
        target_accept=0.8, store_dtype="bfloat16", baseline_ess_per_sec=0.03, fused=False,
        label=(
            "min-ESS/sec/chip, NUTS 1000-param non-centered hierarchical "
            "(99.8K obs, {chains} chains, sufficient-statistic likelihood)"
        ),
    ),
    "hier1000_full": dict(
        family="hier", num_groups=998, obs_per_group=100, suffstats=False,
        num_chains=128, num_warmup=400, num_samples=400, max_tree_depth=10,
        target_accept=0.8, store_dtype=None, baseline_ess_per_sec=0.03, fused=False,
        label=(
            "min-ESS/sec/chip, NUTS 1000-param non-centered hierarchical "
            "(99.8K obs, {chains} chains, full-data likelihood)"
        ),
    ),
    # Poisson event rates, 1000 groups x 100 counts: the sufficient-statistic
    # collapse (per-group sums), the Poisson sibling of hier1000.
    "poisson1000": dict(
        family="poisson", num_groups=1000, obs_per_group=100,
        num_chains=512, num_warmup=400, num_samples=1000, max_tree_depth=10,
        target_accept=0.9, store_dtype="bfloat16", baseline_ess_per_sec=0.03, fused=False,
        label=(
            "min-ESS/sec/chip, NUTS 1000-group hierarchical Poisson rates "
            "(100K obs, {chains} chains, sufficient-statistic likelihood)"
        ),
    ),
    # The non-collapsible Poisson row (bench.py:164-181): per-count
    # covariates force full-data evaluations, through K3 on every leapfrog.
    "poisson1000_cov": dict(
        family="poisson", num_groups=1000, obs_per_group=100, covariate_dim=4,
        num_chains=512, num_warmup=400, num_samples=400, max_tree_depth=8,
        target_accept=0.9, store_dtype="bfloat16", baseline_ess_per_sec=0.03, fused=True,
        label=(
            "min-ESS/sec/chip, NUTS 1000-group hierarchical Poisson "
            "regression (100K obs, {chains} chains, fused CUDA)"
        ),
    ),
    # The standalone funnel: centered eight schools, the divergence stress.
    "funnel8": dict(
        family="funnel", num_chains=1024, num_warmup=500, num_samples=500,
        max_tree_depth=10, target_accept=0.8, store_dtype=None,
        baseline_ess_per_sec=None, fused=False,
        label="min-ESS/sec/chip, NUTS centered eight-schools funnel ({chains} chains)",
    ),
}

# The funnel detail row as the reference builds it next to a GLM config
# (bench.py:540-546): the standalone funnel at 512 chains, 400 + 400, target
# 0.9.
FUNNEL_DETAIL = dict(CONFIGS["funnel8"], num_chains=512, num_warmup=400, num_samples=400,
                     target_accept=0.9)

# Environment overrides of a config's settings, as the reference reads them.
ENV_OVERRIDES = {
    "BENCH_CHAINS": "num_chains",
    "BENCH_SAMPLES": "num_samples",
    "BENCH_WARMUP": "num_warmup",
    "BENCH_DEPTH": "max_tree_depth",
    "BENCH_THIN": "thin",
}


def config_from_env(name: str, environ=os.environ) -> dict:
    """``CONFIGS[name]`` with the ``ENV_OVERRIDES`` found in ``environ`` and
    its label formatted with the chain count."""
    cfg = dict(CONFIGS[name])
    for var, key in ENV_OVERRIDES.items():
        if environ.get(var):
            cfg[key] = int(environ[var])
    cfg["label"] = cfg["label"].format(chains=cfg["num_chains"])
    return cfg


def plain_glm_log_prob(params, data):
    """The plain GLM's data-aware log density (reference ``bench.py:242-
    248``): the logistic likelihood of ``data["X"]`` (f32) and ``data["y"]``
    with softplus as ``logaddexp(s, 0)``, and a unit normal prior."""
    beta = params["beta"]
    s = data["X"] @ beta
    ll = (data["y"] * s - torch.logaddexp(s, torch.zeros_like(s))).sum()
    return ll + Normal(0.0, 1.0).log_prob(beta).sum()


plain_glm_log_prob.graph_safe = True


def fused_glm_value_log_prob(params, data):
    """glm100_fused's value path, the reference bench's ``log_prob`` beside
    its fused value+grad (``bench.py:225-236``): ``s = X beta`` with beta
    rounded to X's dtype (bf16) and float32 products, the logistic
    likelihood (softplus as ``logaddexp(s, 0)``), the padded rows' constant
    and a unit normal prior, on :func:`build_problem`'s data. Plain
    PyTorch, no kernel (the ensemble sampler's batched value)."""
    beta = params["beta"]
    d = data["dim"]
    s = data["Xp"][:, :d].float() @ beta.to(data["Xp"].dtype).float()
    ll = (data["yp"] * s - torch.logaddexp(s, torch.zeros_like(s))).sum()
    return ll + data["pad_const"] + Normal(0.0, 1.0).log_prob(beta).sum()


def hier_full_log_prob(params, data):
    """hier1000_full's data-aware log density over every observation
    ``data["y"] (G, n)`` (reference ``bench.py:273-282``)."""
    mu, log_tau, theta_raw = params["mu"], params["log_tau"], params["theta_raw"]
    theta = mu + torch.exp(log_tau) * theta_raw
    lp = Normal(0.0, 5.0).log_prob(mu)
    lp = lp + Normal(0.0, 1.0).log_prob(log_tau)
    lp = lp + Normal(0.0, 1.0).log_prob(theta_raw).sum()
    return lp + Normal(theta[:, None], 1.0).log_prob(data["y"]).sum()


hier_full_log_prob.graph_safe = True


def build_problem(cfg, device=None):
    """Return ``(log_prob_fn, initial_params, data, extra_kwargs)`` on
    ``device`` (None: the card)."""
    fused = cfg.get("fused", True)
    x_dtype = torch.float32 if cfg.get("x_dtype") == "float32" or not fused else torch.bfloat16
    if cfg["family"] == "glm":
        spec = make_logistic_regression(
            num_features=cfg["num_features"], num_obs=cfg["num_obs"], seed=0,
            data_dtype=x_dtype, device=device,
        )
        if not fused:
            return plain_glm_log_prob, spec.initial_params, {"X": spec.X, "y": spec.y}, {}
        data = prepare_fused_logistic_data(spec.X, spec.y, quantize=cfg.get("quantize"),
                                           device=device)
        extra = {"value_and_grad_fn": make_fused_logistic_vag(prior_scale=1.0)}
        return None, spec.initial_params, data, extra
    if cfg["family"] == "linear":
        spec = make_linear_regression(
            num_features=cfg["num_features"], num_obs=cfg["num_obs"], seed=0,
            data_dtype=x_dtype, device=device,
        )
        data = prepare_fused_linear_data(spec.X, spec.y, device=device)
        extra = {"value_and_grad_fn": make_fused_linear_vag(prior_scale=1.0)}
        return None, spec.initial_params, data, extra
    if cfg["family"] == "hier":
        spec = make_hierarchical_normal(
            num_groups=cfg["num_groups"], obs_per_group=cfg["obs_per_group"], seed=0,
            device=device,
        )
        if cfg.get("suffstats"):
            data = prepare_hier_normal_data(spec.y, device=device)
            extra = {"value_and_grad_fn": make_hier_normal_vag()}
            return hier_suffstat_log_prob, spec.initial_params, data, extra
        return hier_full_log_prob, spec.initial_params, {"y": spec.y}, {}
    if cfg["family"] == "poisson":
        spec = make_poisson_event_rates(
            num_groups=cfg["num_groups"], obs_per_group=cfg["obs_per_group"],
            covariate_dim=cfg.get("covariate_dim", 0), seed=0, device=device,
        )
        if cfg.get("covariate_dim", 0) > 0:
            data = prepare_fused_poisson_data(spec.y, spec.X, device=device)
            log_prob, vag = make_fused_poisson_model()
        else:
            data = prepare_poisson_rates_data(spec.y, device=device)
            log_prob, vag = make_poisson_rates_model()
        return log_prob, spec.initial_params, data, {"value_and_grad_fn": vag}
    if cfg["family"] == "funnel":
        spec = eight_schools(centered=True, device=device)
        return spec.log_prob, spec.initial_params, None, {}
    raise ValueError(f"unknown family: {cfg['family']!r}")


def lockstep_leaves(steps: torch.Tensor) -> torch.Tensor:
    """Leapfrogs a batched NUTS transition executes for every chain, per
    draw, from ``steps`` ``(C, S)`` (``num_integration_steps``): the root
    leaf, then two leapfrogs per pair iteration until the last chain's tree
    ends, ``1 + 2 * max over chains of ceil((leaves - 1) / 2)``, ``(S,)``.
    Exact for the port's pair loop at one pair iteration per check
    (``graphs.PAIRS_PER_REPLAY = 1``), as for the reference's."""
    iters = torch.ceil(torch.clamp(steps.double() - 1.0, min=0.0) / 2.0)
    return 1.0 + 2.0 * iters.amax(dim=0)


def roofline_detail(result, cfg, data, wall: float, device) -> dict:
    """The bench line's ``detail.roofline`` for a GLM config: the
    reference's ``_mfu_detail`` (``bench.py:330-385``), with its fields,
    accounting and rounding, on this run's counts and the port's own data.

    Only *useful* flops count: the chains' true leapfrog counts, summed from
    ``num_integration_steps``; the batched loop runs every chain until the
    last chain's tree ends, so the hardware executes ``lockstep_tax`` times
    as many (``executed_mfu_pct``; only at ``thin == 1``). Warmup leapfrogs
    are not stored; they are estimated at the sampling phase's mean steps a
    draw. X is read once a call by the fused kernels and twice by autograd
    (forward and backward). The work is the port's padded X
    (``ops/glm.py`` pads columns to a multiple of 16 and no rows): at
    glm100_fused ``Xp`` is 10,000 x 112, so a chain-leapfrog is 4.48 MFLOP
    (the reference's 10,240 x 128: 5.24). Peaks are those of X's dtype on
    ``device`` (:func:`~mlx_mcmc_tpu_torch.utils.roofline.device_peaks`)."""
    steps = torch.as_tensor(result.info.num_integration_steps)
    sampling_leapfrogs = float(steps.double().sum())  # over (chains, draws)
    # With thin > 1 a stored draw sums `thin` transitions' counts, so the
    # sampling phase covers num_samples * thin steps.
    thin = cfg.get("thin", 1)
    total_leapfrogs = sampling_leapfrogs * (1.0 + cfg["num_warmup"] / (cfg["num_samples"] * thin))
    lockstep = None
    if thin == 1:
        executed = float(lockstep_leaves(steps).sum())
        lockstep = executed * cfg["num_chains"] / sampling_leapfrogs
    X, x_reads = (data["Xp"], 1.0) if cfg["fused"] else (data["X"], 2.0)
    n_eff, d_eff = X.shape
    flops = total_leapfrogs * glm_vag_flops(n_eff, d_eff)
    # X is streamed once a *call* (every chain shares it)
    calls = total_leapfrogs / cfg["num_chains"]
    bytes_total = calls * glm_vag_bytes(n_eff, d_eff, X.element_size(), x_reads)
    out = {
        "total_leapfrogs": int(total_leapfrogs),
        "flop_count": "useful (per-chain true tree sizes; warmup estimated)",
    }
    out.update(roofline_report(flops, bytes_total, wall, device, X.dtype))
    if lockstep is not None:
        out["lockstep_tax"] = round(lockstep, 3)
        if "mfu_pct" in out:  # a card of unknown peaks gives no MFU
            out["executed_mfu_pct"] = round(out["mfu_pct"] * lockstep, 2)
        out["wasted_leapfrog_pct"] = round(100.0 * (1.0 - 1.0 / lockstep), 1)
    return out


def run_config(cfg, seed: int = 1, problem=None):
    """One run of ``cfg`` through ``sample()``, timed to the device ESS.

    Returns ``(metrics, result, ess)``; ``ess`` is the (P,) device ESS. A
    GLM config's metrics add :func:`roofline_detail` (``"roofline"``),
    computed after the wall was taken."""
    log_prob, initial_params, data, extra = problem or build_problem(cfg)
    launches0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = sample(
        log_prob, initial_params, data=data,
        num_samples=cfg["num_samples"], num_warmup=cfg["num_warmup"],
        num_chains=cfg["num_chains"], kernel="nuts", seed=seed,
        max_tree_depth=cfg["max_tree_depth"], target_accept=cfg["target_accept"],
        store_dtype=cfg["store_dtype"], static_schedule=cfg.get("static_schedule", False),
        **extra,
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
        "final_step_size": float(result.tunables.step_size),
        "ess_backend": "device",
        "launches": {k: v - launches0[k] for k, v in launch_counts().items()},
        "host_syncs": result.host_syncs,
        "graph_replays": result.graph_replays,
        "pairs_per_replay": graphs.PAIRS_PER_REPLAY,
    }
    if cfg["family"] == "glm":
        metrics["roofline"] = roofline_detail(result, cfg, data, wall, flat.device)
    return metrics, result, ess


def _ms_per_call(fn, arg, reps: int = 50) -> float:
    fn(arg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(arg)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _elementwise_vag(z):
    return -0.5 * (z * z).sum(-1), -z


_elementwise_vag.graph_safe = True


def nuts_loop_costs(name: str, vag, Z, tunables, r0, U, depth: int) -> dict:
    """One NUTS step of ``vag`` from ``Z`` at ``tunables`` with momenta
    ``r0`` and uniform table ``U``, timed from CUDA events: ms per pair
    iteration run eagerly (one host check per iteration; ``<name>_iterations``
    host checks), and, where ``vag`` is captured, through the transition's
    CUDA graphs (per pair iteration run, ``graphs.PAIRS_PER_REPLAY`` per
    replay, and per step; None where not captured). Keys start with
    ``name``."""
    from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel

    init_fn, step_fn = make_nuts_kernel(vag, max_tree_depth=depth)
    state = init_fn(Z)
    step_fn(state, tunables, r0, U)
    (_, _, syncs), ms = elapsed_ms(lambda: step_fn(state, tunables, r0, U), Z.device)
    out = {f"{name}_ms_per_iteration": ms / syncs, f"{name}_iterations": syncs,
           f"{name}_graph_ms_per_iteration": None}
    if Z.device.type == "cuda" and graphs.captures(vag):
        transition = graphs.GraphedTransition(vag, max_tree_depth=depth)
        transition.step(state, tunables, r0, U)  # captures
        replays0 = transition.graphs["pairs"].replays
        _, ms = elapsed_ms(lambda: transition.step(state, tunables, r0, U), Z.device)
        replays = transition.graphs["pairs"].replays - replays0
        out[f"{name}_graph_ms_per_iteration"] = ms / (replays * transition.k)
        out[f"{name}_graph_ms_per_step"] = ms
    return out


def loop_costs() -> dict:
    """Costs inside the NUTS loop, at the funnel detail row's shape
    (``FUNNEL_DETAIL``: 512 chains, depth cap 10, centered eight schools):
    :func:`nuts_loop_costs` with a trivial value+grad (the loop body alone)
    and with the generic one; and the generic value+grad per call beside
    ``vmap(grad_and_value)``, the form it replaced."""
    from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
    from mlx_mcmc_tpu_torch.kernels.base import Tunables
    from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

    chains, depth = FUNNEL_DETAIL["num_chains"], FUNNEL_DETAIL["max_tree_depth"]
    spec = eight_schools(centered=True)
    flp, _, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    Z = 0.3 * torch.randn(chains, 10, generator=gen, device="cuda")
    generic = make_batched_value_and_grad(flp)
    grad_and_value = torch.func.vmap(torch.func.grad_and_value(flp))
    out = {
        "generic_vag_ms": _ms_per_call(generic, Z),
        "vmap_grad_and_value_ms": _ms_per_call(grad_and_value, Z),
    }
    tun = Tunables(torch.tensor(0.05, device="cuda"), torch.ones(10, device="cuda"))
    r0 = torch.randn(chains, 10, generator=gen, device="cuda")
    U = torch.rand(chains, 1 << (depth - 1), 4, generator=gen, device="cuda")
    for name, vag in [("body", _elementwise_vag), ("funnel", generic)]:
        out.update(nuts_loop_costs(name, vag, Z, tun, r0, U, depth))
    out["pairs_per_replay"] = graphs.PAIRS_PER_REPLAY
    return out


def k_sweep(names, ks=(1, 2, 4, 8), emit=None) -> dict:
    """For each config in ``names`` and each k in ``ks``: a full run with
    ``graphs.PAIRS_PER_REPLAY = k`` (warm: its capture), then the same run
    timed (wall to the device ESS, host syncs, graph replays, launches,
    sampler statistics, which must not move with k); then the config cut
    to 100 + 100 with ``static_schedule=True`` (warm, then timed; k =
    "static"). ``emit(name, k, metrics)`` after each."""
    emit = emit or (lambda name, k, metrics: None)
    keep = graphs.PAIRS_PER_REPLAY
    out = {}
    try:
        for name in names:
            cfg = CONFIGS[name]
            problem = build_problem(cfg)
            for k in ks:
                graphs.PAIRS_PER_REPLAY = k
                run_config(cfg, seed=0, problem=problem)
                metrics, _, _ = run_config(cfg, seed=1, problem=problem)
                out.setdefault(name, {})[k] = metrics
                emit(name, k, metrics)
            static = dict(cfg, num_warmup=100, num_samples=100, static_schedule=True)
            run_config(static, seed=0, problem=problem)
            metrics, _, _ = run_config(static, seed=1, problem=problem)
            out[name]["static"] = metrics
            emit(name, "static", metrics)
            del problem
    finally:
        graphs.PAIRS_PER_REPLAY = keep
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


def module_from(root: str, name: str = "mlx_mcmc_tpu_torch.bench"):
    """Module ``name`` of the package as the checkout at ``root`` has it
    (default this module), imported as a module tree of its own beside this
    one (its kernels build under ``root``)."""
    if not (Path(root) / "mlx_mcmc_tpu_torch" / "bench.py").is_file():
        raise FileNotFoundError(f"no mlx_mcmc_tpu_torch package under {root}")

    def ours():
        return [k for k in sys.modules if k.split(".")[0] == "mlx_mcmc_tpu_torch"]

    mine = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, root)
    try:
        return importlib.import_module(name)
    finally:
        sys.path.remove(root)
        for k in ours():
            del sys.modules[k]
        sys.modules.update(mine)


# The kernels each config's main path runs, timed by ``paired_times`` at the
# config's shape: (label, wrapper name in this module, family of the data;
# "glm_int8" is the GLM data stored as int8, the scales folded into Z;
# "glm_f32" and "linear_f32" the data with X in float32). The other configs
# run no kernel but Philox: ``paired_times`` gives them their runs alone.
PAIRED_KERNELS = {
    "glm100_fused": [("K1", "fused_logistic_vag_cuda", "glm"),
                     ("K2", "fused_linear_vag_cuda", "linear"),
                     ("K4", "fused_hoisted_vag_cuda", "glm"),
                     ("K1_int8", "fused_logistic_vag_cuda", "glm_int8"),
                     ("K1_f32", "fused_logistic_vag_cuda", "glm_f32"),
                     ("K2_f32", "fused_linear_vag_cuda", "linear_f32"),
                     ("K4_f32", "fused_hoisted_vag_cuda", "glm_f32")],
    "glm1000_fused": [("K1", "fused_logistic_vag_cuda", "glm"),
                      ("K1_int8", "fused_logistic_vag_cuda", "glm_int8"),
                      ("K1_f32", "fused_logistic_vag_cuda", "glm_f32")],
    "poisson1000_cov": [("K3", "fused_poisson_vag_cuda", "poisson")],
}


def _kernel_call(pkg, wrapper: str, cfg: dict, family: str):
    """One call of ``pkg``'s kernel wrapper at ``cfg``'s shape, on this
    module's data for the config (so every package gets the same inputs)
    and chain positions drawn from a fixed seed: unit scale for glm100 (|s|
    ~ 1, as its posterior gives), 0.05 for glm1000, near the generator's
    scale for the Poisson model."""
    base, _, form = family.partition("_")
    int8 = form == "int8"
    data = build_problem(dict(cfg, family=base, quantize="int8" if int8 else None,
                              x_dtype="float32" if form == "f32" else None))[2]
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
    # f32 X's transpose travels with the data; a checkout whose wrappers
    # take no XpT (from before it did) makes its own.
    xt = {"XpT": data["XpT"]} if "XpT" in data and "XpT" in inspect.signature(fn).parameters else {}
    if wrapper == "fused_hoisted_vag_cuda":
        return lambda: fn(data["Xp"], Z, **xt)
    return lambda: fn(data["Xp"], data["yp"], Z, **xt)


def paired_times(names, against: str | None = None, runs: bool = True, emit=None,
                 kernels: bool = True) -> dict:
    """For each config in ``names``: device ms per call of each kernel its
    main path runs (``PAIRED_KERNELS``) at its shape, with the host's
    enqueue hidden (``kernel_ms``) and per wrapper call (``call_ms``), and
    the device ms of each CUDA kernel a call launches; with ``runs``, one
    full run of the config (wall to the device ESS, launches, host syncs,
    min-ESS) and the device's busy share over a 20 + 20 run under the
    profiler (``emit(phase, name, results)`` after each phase, so a run cut
    short keeps what it measured); without ``kernels``, the runs alone. With ``against``, the root of another
    checkout, the same for that checkout's package in this process, in
    turns (other, this, this, other), so both are measured on one card in
    one call. The kernels get this package's inputs; each package samples
    through its own data and value+grad (an older checkout's GLM data came
    from numpy's generator); a short run of each first takes the start-up
    costs out of the timed runs."""
    packages = {"this": sys.modules[__name__]}
    if against:
        packages["other"] = module_from(against)
    order = ["other", "this", "this", "other"] if against else ["this", "this"]
    emit = emit or (lambda phase, name, res: None)
    out = {}
    for name in names:
        cfg = CONFIGS[name]
        res = out[name] = {key: {"kernel_ms": {}, "call_ms": {}, "kernels_ms": {}, "runs": []}
                           for key in packages}
        for label, wrapper, family in PAIRED_KERNELS.get(name, []) if kernels else []:
            calls = {key: _kernel_call(pkg, wrapper, cfg, family) for key, pkg in packages.items()}
            for key in order:
                res[key]["kernel_ms"].setdefault(label, []).append(device_ms(calls[key]))
            for key in order:
                res[key]["call_ms"].setdefault(label, []).append(
                    device_ms(calls[key], hide_host=False))
            for key in packages:
                res[key]["kernels_ms"][label] = kernels_ms(calls[key])
            del calls
        if kernels:
            emit("kernels", name, res)
        if not runs:
            continue
        problems = {key: pkg.build_problem(cfg) for key, pkg in packages.items()}
        for key, pkg in packages.items():
            pkg.run_config(dict(cfg, num_warmup=20, num_samples=20), seed=0, problem=problems[key])
        for key in order:
            metrics, _, _ = packages[key].run_config(cfg, seed=1, problem=problems[key])
            res[key]["runs"].append({k: metrics.get(k) for k in (
                "wall_seconds", "min_ess", "mean_accept", "mean_tree_depth", "divergences",
                "host_syncs", "graph_replays", "pairs_per_replay")}
                                    | {"launches": metrics["launches"]})
        emit("runs", name, res)
        short = dict(cfg, num_warmup=20, num_samples=20)
        for key, pkg in packages.items():
            res[key]["busy_20_20"] = _device_busy(
                lambda: pkg.run_config(short, seed=2, problem=problems[key]))
        emit("busy", name, res)
        del problems
    return out


def rounded(metrics: dict, cfg: dict) -> dict:
    """``run_config``'s metrics rounded as the reference's bench rounds them
    (``bench.py:485-501``); ``ess_per_sec`` from the unrounded ESS and wall.
    The port's own fields (launches, host syncs, replays) stay as they are."""
    draws = cfg["num_chains"] * cfg["num_samples"]
    return dict(
        metrics,
        wall_seconds=round(metrics["wall_seconds"], 2),
        min_ess=round(metrics["min_ess"], 1),
        median_ess=round(metrics["median_ess"], 1),
        ess_per_sec=round(metrics["min_ess"] / metrics["wall_seconds"], 2),
        divergence_rate=round(metrics["divergences"] / draws, 5),
        mean_accept=round(metrics["mean_accept"], 3),
        mean_tree_depth=round(metrics["mean_tree_depth"], 2),
    )


def bench_line(cfg: dict, metrics: dict, **detail) -> dict:
    """The reference's JSON line for ``cfg``'s timed run: value rounded to
    2 places, ``vs_baseline`` to 1, the statistics as ``rounded`` gives
    them, ``detail`` added."""
    metrics = rounded(metrics, cfg)
    ess_per_sec = metrics.pop("ess_per_sec")
    baseline = cfg["baseline_ess_per_sec"]
    return {
        "metric": cfg["label"],
        "value": round(ess_per_sec, 2),
        "unit": "ess/s",
        "vs_baseline": round(ess_per_sec / baseline, 1) if baseline else None,
        "detail": dict(metrics, **detail),
    }


def main() -> None:
    command = sys.argv[1] if len(sys.argv) > 1 else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    if command == "loop":
        print(json.dumps(dict(loop_costs(), device=smi)))
        return
    if command == "ksweep":
        names = [a for a in sys.argv[2:] if a in CONFIGS] or [
            "glm100_fused", "glm1000_fused", "poisson1000_cov"]

        def emit_k(config, k, metrics):
            print(json.dumps({"phase": "ksweep", "config": config, "device": smi, **metrics,
                              "pairs_per_replay": k}), flush=True)

        k_sweep(names, emit=emit_k)
        return
    if command == "paired":
        args = sys.argv[2:]
        against = args[args.index("--against") + 1] if "--against" in args else None
        names = [a for a in args if a in CONFIGS] or ["glm100_fused", "poisson1000_cov"]

        def emit(phase, config, res):
            print(json.dumps({"phase": phase, "config": config, "device": smi, **res}), flush=True)

        paired_times(names, against, "--no-runs" not in args, emit, "--no-kernels" not in args)
        return
    cfg = config_from_env(os.environ.get("BENCH_CONFIG") or command or "glm100_fused")
    t0 = time.perf_counter()
    problem = build_problem(cfg)
    data_seconds = time.perf_counter() - t0
    run_config(cfg, seed=0, problem=problem)  # warm run
    metrics, _, _ = run_config(cfg, seed=1, problem=problem)
    detail = {"data_seconds": data_seconds, "device": torch.cuda.get_device_name(0)}
    if cfg["family"] == "glm" and not os.environ.get("BENCH_SKIP_FUNNEL"):
        del problem
        fproblem = build_problem(FUNNEL_DETAIL)
        run_config(FUNNEL_DETAIL, seed=0, problem=fproblem)  # warm run
        fmetrics, _, _ = run_config(FUNNEL_DETAIL, seed=1, problem=fproblem)
        detail["funnel_eight_schools"] = rounded(fmetrics, FUNNEL_DETAIL)
    print(json.dumps(bench_line(cfg, metrics, **detail)))


if __name__ == "__main__":
    main()
