"""ESS/s across kernels and model scales, on the card.

Counterpart of the repository's ``benchmarks/run_all.py``, case for case:
min-ESS/s of each (model, kernel) pair, a warm run (seed 0: graph captures,
allocator) and then the timed one (seed 1), the wall ending when the draws
are on the host; ESS by ``diagnostics.effective_sample_size`` on the host
(the native engine from 2^18 elements up). The quick set (the default):

  - the example-scale models of the reference's examples: a normal's mean
    and scale (2 parameters, 100 observations) under Metropolis, HMC, NUTS,
    MALA, ChEES and the ensemble sampler; a Beta A/B test and a Gamma rate
    through transforms (NUTS);
  - NUTS against ChEES (and HMC) where the batched loop pays the deepest
    chain's tree a draw: an isotropic Gaussian scale mixture (sigma 1 and
    10, D = 50) and a bank of 25 two-dimensional Rosenbrock valleys of
    curvature 0.5..8 (256 chains each); then eight schools, a 102-parameter
    hierarchical normal over 10K observations and the 100-parameter
    logistic GLM over 10K observations (f32 X, autograd, 64 chains).

``--full`` adds the 1000-parameter logistic GLM over 100K observations
(bf16 X through K1's wide path, 128 chains, 400 + 400). NUTS rows carry
``lockstep_tax``: executed over useful leapfrogs (``bench.lockstep_leaves``).
The example-scale models run eagerly, as the README quick start does: their
distributions' support checks (``ops/math.safe_where_log_prob``) make a
tensor from a host value, which a CUDA graph capture refuses. The others
are tensor work on tensors made beforehand, declare ``graph_safe`` and
sample through the transition's CUDA graphs; the ensemble steps run
eagerly.

    python -m mlx_mcmc_tpu_torch.benchmarks.run_all [--full] [--json PATH] [--device cpu]
"""

from __future__ import annotations

import json
import math
import sys
import time

import numpy as np
import torch

from mlx_mcmc_tpu_torch import Beta, Exponential, Gamma, HalfNormal, Normal, sample, sample_ensemble
from mlx_mcmc_tpu_torch.bench import fused_glm_value_log_prob, lockstep_leaves
from mlx_mcmc_tpu_torch.benchmarks import card, device_from_argv
from mlx_mcmc_tpu_torch.diagnostics import effective_sample_size
from mlx_mcmc_tpu_torch.models import (
    eight_schools,
    make_hierarchical_normal,
    make_logistic_regression,
)
from mlx_mcmc_tpu_torch.ops.glm import make_fused_logistic_vag, prepare_fused_logistic_data


def graph_safe(fn):
    """Declare that CUDA graphs may capture ``fn`` (``inference/graphs.py``)."""
    fn.graph_safe = True
    return fn


def min_ess(result) -> float:
    return min(float(np.min(effective_sample_size(v.reshape(v.shape[0], v.shape[1], -1))))
               for v in result.to_numpy().values())


def _timed(run) -> tuple:
    """A warm run (seed 0), then ``(result, wall)`` of the timed one (seed
    1) up to its draws on the host."""
    run(0)
    t0 = time.perf_counter()
    res = run(1)
    res.to_numpy()
    return res, time.perf_counter() - t0


def run_case(name, log_prob, init, kernel, device, data=None, vag=None, **kwargs) -> dict:
    settings = dict(num_samples=500, num_warmup=500, num_chains=16, device=device)
    settings.update(kwargs)
    extra = {k: v for k, v in (("data", data), ("value_and_grad_fn", vag)) if v is not None}
    res, wall = _timed(lambda seed: sample(log_prob, init, kernel=kernel, seed=seed,
                                           **settings, **extra))
    ess = min_ess(res)
    row = {"case": name, "kernel": kernel, "wall_s": wall, "min_ess": ess,
           "ess_per_s": ess / wall, "divergences": res.divergences}
    if kernel == "nuts":
        steps = torch.as_tensor(res.info.num_integration_steps).double()  # (C, S)
        row["mean_leapfrogs_per_draw"] = round(float(steps.mean()), 2)
        row["lockstep_tax"] = round(
            float(lockstep_leaves(steps).sum()) * steps.shape[0] / float(steps.sum()), 3)
    return row


def run_ensemble_case(name, log_prob, init, device, **kwargs) -> dict:
    settings = dict(num_samples=500, num_warmup=500, num_walkers=64, device=device)
    settings.update(kwargs)
    res, wall = _timed(lambda seed: sample_ensemble(log_prob, init, seed=seed, **settings))
    ess = min_ess(res)
    return {"case": name, "kernel": "ensemble", "wall_s": wall, "min_ess": ess,
            "ess_per_s": ess / wall, "divergences": 0}


def cases(device, full: bool = False) -> list:
    rows = []
    # -- example-scale models (the reference's examples 01-06) -------------
    np.random.seed(42)
    y = torch.as_tensor(np.random.normal(5.0, 2.0, 100).astype(np.float32), device=device)

    def normal_model(p):
        return (Normal(0, 10).log_prob(p["mu"]) + HalfNormal(5).log_prob(p["sigma"])
                + Normal(p["mu"], p["sigma"]).log_prob(y).sum())

    start = {"mu": 0.0, "sigma": 1.0}
    for kernel in ("metropolis", "hmc", "nuts", "mala", "chees"):
        rows.append(run_case("normal(2p,100obs)", normal_model, start, kernel, device,
                             step_size=0.3 if kernel == "metropolis" else 0.1))
    rows.append(run_ensemble_case("normal(2p,100obs)", normal_model, start, device))

    conv = int(np.random.binomial(1000, 0.12)), int(np.random.binomial(1000, 0.15))

    def ab_model(p):
        lp = Beta(1, 1).log_prob(p["p_A"]) + Beta(1, 1).log_prob(p["p_B"])
        lp = lp + Beta(conv[0] + 1, 1000 - conv[0] + 1).log_prob(p["p_A"])
        return lp + Beta(conv[1] + 1, 1000 - conv[1] + 1).log_prob(p["p_B"])

    rows.append(run_case("beta-ab(2p)", ab_model, {"p_A": 0.1, "p_B": 0.1}, "nuts", device,
                         transforms={"p_A": "logit", "p_B": "logit"}))

    waiting = torch.as_tensor(np.random.exponential(1 / 3.0, 50).astype(np.float32),
                              device=device)

    def rate_model(p):
        return Gamma(2.0, 1.0).log_prob(p["rate"]) + Exponential(p["rate"]).log_prob(waiting).sum()

    rows.append(run_case("gamma-rate(1p)", rate_model, {"rate": 2.0}, "nuts", device,
                         transforms={"rate": "log"}))

    # -- lockstep-hostile targets: NUTS against ChEES ----------------------
    # An isotropic Gaussian scale mixture: the local curvature depends on
    # which component dominates, so the chains' tree depths diverge and the
    # batched loop pays the deepest a draw; ChEES runs one jittered
    # trajectory length for every chain.
    d_mix = 50
    c1 = -d_mix * math.log(math.sqrt(2 * math.pi)) + math.log(0.5)
    c2 = -d_mix * math.log(10.0 * math.sqrt(2 * math.pi)) + math.log(0.5)

    @graph_safe
    def scale_mixture(p):
        q = (p["x"] * p["x"]).sum()
        return torch.logaddexp(-0.5 * q + c1, -0.5 * q / 100.0 + c2)

    for kernel in ("nuts", "chees", "hmc"):
        rows.append(run_case("scale-mixture(50p)", scale_mixture,
                             {"x": torch.zeros(d_mix, device=device)}, kernel, device,
                             num_chains=256, jitter=3.0, max_tree_depth=8))

    # 25 independent 2-D Rosenbrock valleys of curvature 0.5..8: curvature
    # varies along each valley and across them.
    b_pairs = 25
    b_scales = torch.as_tensor(np.geomspace(0.5, 8.0, b_pairs).astype(np.float32),
                               device=device)

    @graph_safe
    def banana_bank(p):
        x = p["x"].reshape(b_pairs, 2)
        x1, x2 = x[:, 0], x[:, 1]
        return -((x1 - 1.0) ** 2 / 20.0 + b_scales * (x2 - x1 * x1) ** 2).sum()

    for kernel in ("nuts", "chees"):
        rows.append(run_case("banana-bank(50p)", banana_bank,
                             {"x": torch.zeros(2 * b_pairs, device=device)}, kernel, device,
                             num_chains=256, jitter=1.0, max_tree_depth=8))

    # -- hierarchical and GLM scales ---------------------------------------
    spec8 = eight_schools(device=device)
    for kernel in ("nuts", "chees"):
        rows.append(run_case("eight-schools(10p)", spec8.log_prob, spec8.initial_params, kernel,
                             device))

    hier = make_hierarchical_normal(num_groups=100, obs_per_group=100, device=device)
    rows.append(run_case("hierarchical(102p,10Kobs)", hier.log_prob, hier.initial_params,
                         "nuts", device))

    glm = make_logistic_regression(num_features=100, num_obs=10_000, device=device)

    @graph_safe
    def glm_lp(p, data):
        s = data["X"] @ p["beta"]
        ll = (data["y"] * s - torch.logaddexp(s, torch.zeros_like(s))).sum()
        return ll + Normal(0.0, 1.0).log_prob(p["beta"]).sum()

    for kernel in ("nuts", "chees"):
        rows.append(run_case("glm(100p,10Kobs)", glm_lp,
                             {"beta": torch.zeros(100, device=device)}, kernel, device,
                             data={"X": glm.X, "y": glm.y}, num_chains=64, max_tree_depth=8))

    if full:
        # bf16 X through K1's wide path on the card (f32 X, the plain
        # version, on the CPU)
        x_dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        big = make_logistic_regression(num_features=1000, num_obs=100_000, data_dtype=x_dtype,
                                       device=device)
        fdata = prepare_fused_logistic_data(big.X, big.y, device=device)
        rows.append(run_case("glm-fused(1000p,100Kobs)", fused_glm_value_log_prob,
                             {"beta": torch.zeros(1000, device=device)}, "nuts", device,
                             data=fdata, vag=make_fused_logistic_vag(prior_scale=1.0),
                             num_chains=128, num_samples=400, num_warmup=400,
                             max_tree_depth=8))
    return rows


def table(rows) -> str:
    lines = [f"{'case':28s} {'kernel':10s} {'wall(s)':>8s} {'min ESS':>9s} {'ESS/s':>9s} "
             f"{'div':>4s} {'lockstep':>9s}", "-" * 85]
    for r in rows:
        tax = r.get("lockstep_tax")
        lines.append(f"{r['case']:28s} {r['kernel']:10s} {r['wall_s']:8.2f} {r['min_ess']:9.0f} "
                     f"{r['ess_per_s']:9.1f} {r['divergences']:4d} "
                     f"{('%.2f' % tax) if tax is not None else '':>9s}")
    return "\n".join(lines)


def main() -> None:
    device = device_from_argv()
    smi = card(device)
    print(smi, flush=True)
    rows = cases(device, full="--full" in sys.argv)
    print(table(rows), flush=True)
    artifact = {
        "device": smi,
        "note": ("min-ESS/s per (model, kernel); lockstep_tax (nuts rows) = executed/useful "
                 "leapfrogs of the batched pair loop (the root and two leapfrogs a pair "
                 "iteration until the deepest chain's tree ends, a draw)"),
        "rows": [{k: (round(v, 3) if isinstance(v, float) else v) for k, v in r.items()}
                 for r in rows],
    }
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
        with open(path, "w") as f:
            json.dump(artifact, f, indent=1)
        print("wrote", path, flush=True)
    print(json.dumps(artifact), flush=True)


if __name__ == "__main__":
    main()
