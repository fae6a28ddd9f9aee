"""The single-device benchmark scripts (``mlx_mcmc_tpu_torch/benchmarks``)
on the CPU at small shapes.

- Their arithmetic against the reference scripts' formulas on the same
  arrays: ``flagship_breakdown.phase`` (``benchmarks/flagship_breakdown.py:
  78-92``), ``poisson_roofline.bounds`` at the reference's rates
  (``benchmarks/poisson_roofline.py:208-226``) and ``run_all``'s lockstep
  tax (``benchmarks/run_all.py:71-77``).
- Each script's path end to end at a small shape on the CPU, and the
  entry points' refusal to run on the CPU unasked.
"""

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch.benchmarks import (
    device_from_argv,
    flagship_breakdown,
    nuts_overhead,
    poisson_roofline,
    run_all,
)

CPU = torch.device("cpu")


def _steps(draws, chains, seed):
    return np.random.default_rng(seed).integers(1, 64, size=(draws, chains)).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_phase_is_the_references(seed):
    steps, per_leaf_ms = _steps(40, 16, seed), 0.2393
    # the reference's phase(), verbatim in numpy
    s = steps.astype(np.float64)
    iters = np.ceil(np.maximum(s - 1.0, 0.0) / 2.0)
    lockstep = float(np.sum(1.0 + 2.0 * iters.max(axis=1)))
    useful = float(s.mean(axis=1).sum())
    want = {
        "lockstep_leaves": int(lockstep),
        "useful_leaves": int(useful),
        "lockstep_tax": round(lockstep / useful, 3),
        "mean_leaves_per_draw": round(float(s.mean(axis=1).mean()), 2),
        "max_leaves_per_draw": round(float(s.max(axis=1).mean()), 2),
        "implied_wall_s": round(lockstep * per_leaf_ms / 1e3, 2),
    }
    assert flagship_breakdown.phase(steps, per_leaf_ms) == want


@pytest.mark.parametrize("chains", [128, 256, 512])
def test_poisson_bounds_are_the_references(chains):
    G, N_PER, K, HBM_GBS, EUP_OPS = 1000, 100, 4, 819.0, 4.0e11
    N = G * N_PER
    bytes_fused = N * K * 4 + 2 * chains * (G + K + 2) * 4
    bytes_saved_resid = 2 * chains * N * 4
    got = poisson_roofline.bounds(chains, N, G, K, HBM_GBS, 67.0, EUP_OPS)
    assert got["bound_hbm_with_saved_residual_ms"] == pytest.approx(
        1e3 * (bytes_fused + bytes_saved_resid) / (HBM_GBS * 1e9), rel=1e-12)
    assert got["bound_hbm_fully_fused_ms"] == pytest.approx(
        1e3 * bytes_fused / (HBM_GBS * 1e9), rel=1e-12)
    assert got["bound_exp_ms"] == pytest.approx(1e3 * (2 * N * chains) / EUP_OPS, rel=1e-12)
    assert got["flops"] == 4 * N * K * chains
    assert got["bound_f32_flops_ms"] == pytest.approx(1e3 * 4 * N * K * chains / 67e12)


def test_run_all_lockstep_tax_is_the_references():
    steps = _steps(30, 12, 2).T  # (C, S), as a result stores them
    s = steps.astype(np.float64)
    iters = np.ceil(np.maximum(s - 1.0, 0.0) / 2.0)
    want = round(float(np.sum(1.0 + 2.0 * iters.max(axis=0)) * s.shape[0] / s.sum()), 3)
    t = torch.from_numpy(s)
    from mlx_mcmc_tpu_torch.bench import lockstep_leaves

    assert round(float(lockstep_leaves(t).sum()) * t.shape[0] / float(t.sum()), 3) == want


def test_nuts_overhead_small():
    r = nuts_overhead.measure(CPU, chains=8, dim=5, num_obs=300, t_a=3, t_b=3)
    # the root and two leapfrogs a pair iteration, every transition
    assert r["B_leaves_executed"] == r["B_steps"] + 2 * r["B_pair_iterations"]
    assert r["B_leaves_executed"] >= r["B_leaves_lockstep"]
    assert r["B_lockstep_tax"] >= 1.0
    assert r["A_leapfrog_ms"] > 0 and r["C_iterations"] >= 1
    assert r["C_graph_ms_per_iteration"] is None  # no graphs on the CPU


def test_flagship_breakdown_small():
    r = flagship_breakdown.run(CPU, chains=8, dim=5, num_obs=300, num_warmup=12,
                               num_samples=10, overhead_steps=(2, 2))
    assert r["total_lockstep_leaves"] == (r["warmup"]["lockstep_leaves"]
                                          + r["sampling"]["lockstep_leaves"])
    for name in ("warmup", "sampling"):
        assert r[name]["lockstep_tax"] >= 1.0
    assert r["per_leaf_ms"] == r["nuts_overhead"]["B_per_leaf_ms"]


def test_poisson_roofline_small():
    r = poisson_roofline.run(CPU, num_groups=20, obs_per_group=15, k=3, chains=(4,))
    (row,) = r["rows"]
    assert row["chains"] == 4 and row["ms_per_vag"] > 0 and row["fused_ms_per_vag"] > 0
    assert row["max_abs_lp_gap"] < 1e-2  # float32 sums of 300 terms in two orders
    assert r["hbm_gbs"] is None and "bound_exp_ms" not in row  # no card, no bound


def test_run_all_case_small():
    spec = run_all.eight_schools(device=CPU)
    row = run_all.run_case("eight-schools(10p)", spec.log_prob, spec.initial_params, "nuts", CPU,
                           num_samples=15, num_warmup=15, num_chains=4)
    assert row["kernel"] == "nuts" and row["lockstep_tax"] >= 1.0 and row["min_ess"] > 0
    assert run_all.table([row]).splitlines()[2].startswith("eight-schools(10p)")


def test_entry_points_refuse_the_cpu_unasked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the entry points run there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_from_argv(["prog"])
    assert device_from_argv(["prog", "--device", "cpu"]) == CPU
