"""The port's mesh scripts (``mlx_mcmc_tpu_torch/benchmarks/``:
``scaling``, ``collective_overhead``, ``make_scaling_artifact``) against
the reference's ``tests/test_scaling.py``, on the CPU: weak scaling over 1
and 2 gloo ranks and the refusal of more ranks than the host has, one
``collective_overhead`` run at its smallest size (one process, a world of
one and of two, run in a thread while the scaling test runs), and the
artifact writer's parsing and labels from a bench line that the port's
bench makes, without running the card's rows.
"""

import concurrent.futures
import json

import pytest
import torch

from mlx_mcmc_tpu_torch import bench
from mlx_mcmc_tpu_torch.benchmarks import make_scaling_artifact as artifact_mod
from mlx_mcmc_tpu_torch.benchmarks.collective_overhead import LEAPFROGS, measure
from mlx_mcmc_tpu_torch.benchmarks.scaling import measure_scaling, rank_limit


@pytest.fixture(scope="module")
def overhead():
    """``collective_overhead.measure`` at its smallest size, running in a
    thread while the module's other tests run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(measure, total_chains=4, steps=(3, 6), layouts=(0, 1, 2),
                             data_shape=(4, 4, 16), device="cpu")
        yield future
        future.result(timeout=600)


def test_measure_scaling_reports_efficiency(overhead):
    # tests/test_scaling.py:20-36
    rows = measure_scaling([1, 2], chains_per_shard=2, num_warmup=30, num_samples=30,
                           kernel="hmc", device="cpu")
    assert [r["shards"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    for r in rows:
        assert r["num_chains"] == 2 * r["shards"]
        assert r["min_ess"] > 0 and r["ess_per_sec"] > 0 and r["wall_seconds"] > 0
        assert r["device"] == "cpu"


def test_measure_scaling_rejects_oversubscription():
    # tests/test_scaling.py:39-43: more ranks than the host has cores (on the
    # card: than it has GPUs); nothing starts
    limit = rank_limit(torch.device("cpu"))
    with pytest.raises(ValueError, match="exceeds"):
        measure_scaling([1, limit + 1], num_warmup=2, num_samples=2, device="cpu")


def test_collective_overhead_smallest(overhead):
    out = overhead.result(timeout=600)
    json.dumps(out)
    assert out["layouts"] == ["one process", "world of 1", "world of 2"]
    assert "rehearsal" in out["note"] and out["device"] == "cpu"
    grid, data = out["chain_axis"], out["data_axis"]
    for name in ("world of 1", "world of 2"):
        assert grid[name]["collective_ms_per_step"] == pytest.approx(
            grid[name]["adapt_delta_ms"] - grid["one process"]["adapt_delta_ms"], abs=1e-3)
        # one sum over the shards a leapfrog: HMC at a fixed leapfrog count
        assert data[name]["data_collectives_per_step"] == LEAPFROGS
        assert "data_ms_per_leapfrog" in data[name]
    assert data["one process"]["data_collectives_per_step"] is None
    assert "vs_world_of_one_ms_per_leapfrog" in data["world of 2"]


def test_collective_overhead_refuses_worlds_beyond_the_gpus():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure(layouts=(0, 2))


def test_artifact_parses_bench_lines():
    """The chain rows from the port's own bench lines (no card run), the
    efficiency against 1,024 chains, and the labels."""
    cfg = bench.config_from_env("glm100_fused", {"BENCH_CHAINS": "2048", "BENCH_SAMPLES": "500",
                                                 "BENCH_THIN": "1"})
    assert (cfg["num_chains"], cfg["num_samples"], cfg["thin"]) == (2048, 500, 1)
    rows = []
    for chains, ess in ((1024, 3.0e6), (2048, 6.6e6)):
        metrics = {"wall_seconds": 2.0, "min_ess": ess, "min_ess_param": "beta[0]",
                   "median_ess": ess, "ess_per_sec": ess / 2.0, "divergences": 0,
                   "divergence_rate": 0.0, "mean_accept": 0.8, "mean_tree_depth": 3.0}
        line = bench.bench_line(cfg, metrics, roofline={"mfu_pct": 4.77}, device="card")
        stdout = "glm100_fused: warm run\n" + json.dumps(line) + "\n"
        rows.append(artifact_mod.chain_row(stdout, chains, 500, 1))
    assert rows[1] == {"num_chains": 2048, "num_samples": 500, "thin": 1,
                       "min_ess_per_sec": 3.3e6, "wall_seconds": 2.0, "min_ess": 6.6e6,
                       "divergences": 0, "mfu_pct": 4.77}
    out = artifact_mod.artifact(rows, "H100", [{"shards": 1}], {"note": "x"})
    assert [r["efficiency_vs_1024"] for r in out["chain_scaling"]["rows"]] == [1.0, 1.1]
    assert "rehearsal" in out["weak_scaling"]["device"]
    assert out["chain_scaling"]["device"] == "H100"
    assert artifact_mod.DEFAULT_OUT.endswith("build/mlx_mcmc_tpu_torch/results/scaling.json")
