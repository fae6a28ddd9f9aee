"""The port's bench against the repository's ``bench.py``, on the CPU.

- ``CONFIGS``: every config of the reference, with every setting it names
  equal (target accept: the reference's default 0.8 where it names none;
  labels with "Pallas" read as "CUDA"); the funnel detail row as the
  reference builds it (512 chains, 400 + 400, target 0.9).
- The environment overrides and the config name, as the reference reads
  them.
- The JSON line rounded as the reference rounds it.
- ``build_problem``'s densities for the new families against the
  reference's on the same data at small sizes: the plain GLM, the
  hierarchical normal through sufficient statistics and through every
  observation, and the Poisson rates through sufficient statistics, values
  to 1e-6 relative (float32 sums in another order). Each declares
  ``graph_safe``, so each samples through CUDA graphs on the card.
"""

import json

import bench as ref_bench
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch import bench
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob


def test_configs_are_the_references():
    assert set(bench.CONFIGS) == set(ref_bench.CONFIGS)
    for name, ref in ref_bench.CONFIGS.items():
        got = bench.CONFIGS[name]
        for key, value in ref.items():
            if key == "label":
                assert got[key] == value.replace("Pallas", "CUDA"), name
            else:
                assert got.get(key) == value, (name, key)
        assert got["target_accept"] == ref.get("target_accept", 0.8), name
        assert got.get("store_dtype") == ref.get("store_dtype"), name
        assert got.get("covariate_dim", 0) == ref.get("covariate_dim", 0), name
        assert got["family"] == ref.get("family", "glm"), name


def test_funnel_standalone_and_detail_row():
    funnel = bench.CONFIGS["funnel8"]
    assert (funnel["num_chains"], funnel["num_warmup"], funnel["num_samples"],
            funnel["max_tree_depth"], funnel["target_accept"]) == (1024, 500, 500, 10, 0.8)
    # the reference's detail row: dict(CONFIGS["funnel8"], 512, 400, 400) at
    # _bench_config's target_accept=0.9 (bench.py:543-545)
    ref_detail = dict(ref_bench.CONFIGS["funnel8"], num_chains=512, num_warmup=400,
                      num_samples=400)
    for key, value in ref_detail.items():
        assert bench.FUNNEL_DETAIL[key] == value, key
    assert bench.FUNNEL_DETAIL["target_accept"] == 0.9


def test_config_from_env_reads_the_references_overrides():
    env = {"BENCH_CHAINS": "2048", "BENCH_SAMPLES": "300", "BENCH_WARMUP": "200",
           "BENCH_DEPTH": "7"}
    cfg = bench.config_from_env("hier1000", env)
    assert (cfg["num_chains"], cfg["num_samples"], cfg["num_warmup"], cfg["max_tree_depth"]) == (
        2048, 300, 200, 7)
    assert "2048 chains" in cfg["label"]
    assert bench.CONFIGS["hier1000"]["num_chains"] == 512  # the defaults stay
    plain = bench.config_from_env("glm1000", {})
    assert plain["label"] == ref_bench.CONFIGS["glm1000"]["label"]


def test_main_takes_the_config_from_bench_config_first(monkeypatch):
    seen = {}

    def stop(cfg, device=None):
        seen["cfg"] = cfg
        raise SystemExit

    monkeypatch.setattr(bench, "build_problem", stop)
    monkeypatch.setattr(bench.subprocess, "run", lambda *a, **k: type("R", (), {"stdout": ""})())
    monkeypatch.setenv("BENCH_CONFIG", "poisson1000")
    monkeypatch.setenv("BENCH_CHAINS", "1024")
    monkeypatch.setattr(bench.sys, "argv", ["bench", "hier1000"])
    with pytest.raises(SystemExit):
        bench.main()
    assert seen["cfg"]["num_chains"] == 1024
    assert seen["cfg"]["label"].startswith("min-ESS/sec/chip, NUTS 1000-group hierarchical Poisson rates")


def test_bench_line_is_rounded_as_the_references():
    cfg = bench.config_from_env("glm100_fused", {})
    metrics = {
        "wall_seconds": 6.654321, "min_ess": 14156171.123456, "min_ess_param": "beta[3]",
        "median_ess": 15000000.987654, "ess_per_sec": 2127379.2, "divergences": 3,
        "divergence_rate": 3 / (4096 * 2000), "mean_accept": 0.79342669,
        "mean_tree_depth": 3.0012345, "ess_backend": "device", "launches": {"philox": 2301},
        "host_syncs": 9395, "graph_replays": 11692, "pairs_per_replay": 1,
    }
    line = bench.bench_line(cfg, metrics, data_seconds=1.234, device="card")
    json.dumps(line)
    ess_per_sec = round(14156171.123456 / 6.654321, 2)
    assert line["value"] == round(ess_per_sec, 2)
    assert line["vs_baseline"] == round(ess_per_sec / 0.44, 1)
    assert line["unit"] == "ess/s" and line["metric"] == cfg["label"]
    d = line["detail"]
    assert (d["wall_seconds"], d["min_ess"], d["median_ess"]) == (6.65, 14156171.1, 15000001.0)
    assert d["divergence_rate"] == round(3 / (4096 * 2000), 5)
    assert (d["mean_accept"], d["mean_tree_depth"]) == (0.793, 3.0)
    # the port's own fields stay
    assert (d["host_syncs"], d["graph_replays"], d["launches"], d["data_seconds"]) == (
        9395, 11692, {"philox": 2301}, 1.234)
    assert "ess_per_sec" not in d
    funnel = bench.bench_line(bench.config_from_env("funnel8", {}), metrics)
    assert funnel["vs_baseline"] is None


def _values(problem_t, problem_j, Z):
    t_lp, t_init, t_data, t_extra = problem_t
    j_lp, j_init, j_data, j_extra = problem_j
    if "value_and_grad_fn" in t_extra:
        t_val, _ = t_extra["value_and_grad_fn"](torch.from_numpy(Z), t_data)
        j_val, _ = jax.vmap(lambda z: j_extra["value_and_grad_fn"](z, j_data))(jnp.asarray(Z))
    else:
        flp, _, _ = make_flat_logprob(t_lp, t_init, data_aware=True, device="cpu")
        assert flp.graph_safe
        t_val, _ = make_batched_value_and_grad(flp, t_data)(torch.from_numpy(Z))
        jflp, _, _ = j_make_flat_logprob(j_lp, j_init, data_aware=True)
        j_val = jax.vmap(lambda z: jflp(z, j_data))(jnp.asarray(Z))
    return t_val.numpy(), np.asarray(j_val)


@pytest.mark.parametrize("name, small, scale", [
    ("glm100", dict(num_features=5, num_obs=300), 0.5),
    ("glm1000", dict(num_features=40, num_obs=900), 0.3),
    ("hier1000", dict(num_groups=20, obs_per_group=30), 0.5),
    ("hier1000_full", dict(num_groups=20, obs_per_group=30), 0.5),
    ("poisson1000", dict(num_groups=20, obs_per_group=30), 0.3),
])
def test_new_problems_match_the_references(name, small, scale):
    cfg = dict(bench.CONFIGS[name], **small)
    problem = bench.build_problem(cfg, device="cpu")
    ref_problem = ref_bench.build_problem(dict(ref_bench.CONFIGS[name], **small))
    dim = sum(torch.as_tensor(v).numel() for v in problem[1].values())
    Z = np.random.default_rng(0).normal(scale=scale, size=(8, dim)).astype(np.float32)
    got, ref = _values(problem, ref_problem, Z)
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    source = problem[3].get("value_and_grad_fn") or problem[0]
    assert graphs.captures(source)
