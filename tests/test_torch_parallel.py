"""The port's sharded sampling (``mlx_mcmc_tpu_torch.parallel``) against the
reference's oracles (``tests/test_parallel.py``, ``test_chees.py:114``,
``test_mala.py:144``, ``test_diagnostics.py:187``,
``test_facade.py:150-185``), against the JAX package, and against the
port's own ``sample()``.

Two ranks of a gloo world on the CPU run every multi-rank scenario in one
run (``tests/_torch_parallel_worker.py``), started once for the module;
while they run, the tests compute their in-process counterparts. A world of
one runs in this process on a ``HashStore`` and ends at module teardown.

- Fixed tunables: the draws and every info field of 2 ranks and of a world
  of one equal ``sample()``'s bit for bit (NUTS, HMC, MALA, Metropolis on
  an elementwise model; NUTS through the plain K1 twin at D = 8), so each
  rank numbers its chains from its block's first global index.
- The pooled Welford merge, R-hat and ESS of the two ranks against the
  reference's ``_welford_pmean_reduce``, ``device_rhat(axis_name=)`` and
  ``device_ess(axis_name=)`` under ``shard_map`` over 2 of the 8 virtual
  devices, to ``rtol=1e-5``.
- Adaptive runs against the reference's bands, against ``sample()`` and
  against the reference's ``sample_sharded`` statistically (posterior
  means within the reference's 0.15, sds within 10%). To fit the suite's
  budget the adaptive NUTS scenario is cut to 150 + 300 at depth 6 (the
  worker says why), ChEES to 200 + 200 and the facade's NUTS to 100 + 100,
  each under the reference's band; the reference's sizes run under
  ``-m slow``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_parallel_worker as W
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess, device_ess_chunked, device_rhat
from mlx_mcmc_tpu_torch.kernels.adaptation import build_schedule
from mlx_mcmc_tpu_torch.parallel import sample_sharded
from mlx_mcmc_tpu_torch.parallel import sharded as sharded_mod

KERNELS = tuple(W.FIXED)


def _in_process_refs() -> dict:
    """What the ranks' results are held against, run in this process:
    ``sample()``'s fixed-tunables, GLM, jitter and adaptive runs and the
    reference's ``sample_sharded`` of the adaptive scenario (2 of the 8
    virtual devices)."""
    from mlx_mcmc_tpu import Normal as JNormal
    from mlx_mcmc_tpu.parallel import sample_sharded as j_sample_sharded

    refs = {name: W.result_arrays(sample(model, {"x": torch.zeros(dim)}, **kw))
            for name, (model, dim, kw) in W.FIXED.items()}
    init, data, vag = W.glm_problem()
    refs["glm"] = W.result_arrays(sample(None, init, data=data, value_and_grad_fn=vag,
                                         **W.GLM_RUN))
    refs["jitter"] = W.result_arrays(sample(W.normal_model, {"x": torch.zeros(2)}, **W.JITTER))
    refs["adaptive"] = sample(W.normal_model, {"x": torch.zeros(3)},
                              **W.ADAPTIVE).samples["x"].numpy()
    kw = {k: v for k, v in W.ADAPTIVE.items() if k != "device"}
    ref = j_sample_sharded(lambda p: jnp.sum(JNormal(1.0, 2.0).log_prob(p["x"])),
                           {"x": jnp.zeros(3)}, mesh=_two_devices_mesh(), **kw)
    refs["reference_adaptive"] = np.asarray(ref.samples["x"])
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks' run, with ``refs`` (:func:`_in_process_refs`)
    computed while it runs."""
    two_ranks = W.Ranks(tmp_path_factory.mktemp("ranks"), "tier1")
    try:
        two_ranks.refs = _in_process_refs()
        yield two_ranks
    finally:
        two_ranks.stop()


@pytest.fixture(scope="module")
def world_of_one():
    from mlx_mcmc_tpu_torch.parallel import initialize_distributed

    assert not dist.is_initialized()
    initialize_distributed(device="cpu")
    yield
    dist.destroy_process_group()


def _two_devices_mesh():
    return Mesh(np.asarray(jax.devices()[:2]), ("chains",))


def _assert_same(got: dict, want: dict, prefix: str = "") -> None:
    keys = [k for k in got if k.startswith(prefix)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[k], want[k[len(prefix):]], err_msg=k)


@pytest.mark.parametrize("kernel", KERNELS)
def test_fixed_tunables_bitwise_matches_sample(ranks, kernel):
    # tests/test_parallel.py:40-57 and test_mala.py:144 (there to 1e-5)
    for rank in (0, 1):
        got, _ = ranks.load("fixed", rank)
        _assert_same(got, ranks.refs[kernel], prefix=f"{kernel}_")


@pytest.mark.parametrize("kernel", ["nuts", "mala"])
def test_world_of_one_bitwise_matches_sample(ranks, world_of_one, kernel):
    model, dim, kw = W.FIXED[kernel]
    res = sample_sharded(model, {"x": torch.zeros(dim)}, **kw)
    _assert_same(W.result_arrays(res), ranks.refs[kernel])
    assert res.collectives["adaptation"]["count"] == kw["num_warmup"]  # one mean a step
    assert res.resume_payload["mesh_axes"]["axis_size"] == 1


def test_glm_plain_twin_bitwise(ranks, world_of_one):
    init, data, vag = W.glm_problem()
    want = ranks.refs["glm"]
    one = sample_sharded(None, init, data=data, value_and_grad_fn=vag, **W.GLM_RUN)
    _assert_same(W.result_arrays(one), want)
    for rank in (0, 1):
        _assert_same(ranks.load("glm", rank)[0], want)


def test_chain_blocks_and_jittered_starts(ranks):
    from mlx_mcmc_tpu_torch.inference.engine import jittered_starts

    want = ranks.refs["jitter"]
    c = W.JITTER["num_chains"]
    full = jittered_starts(W.JITTER["seed"], torch.zeros(c, 2), W.JITTER["jitter"]).numpy()
    for rank in (0, 1):
        got, _ = ranks.load("jitter", rank)
        np.testing.assert_array_equal(got.pop("starts"), full[rank * c // 2:(rank + 1) * c // 2])
        _assert_same(got, want)


def test_welford_merge_matches_reference(ranks):
    from mlx_mcmc_tpu.inference.engine import _welford_pmean_reduce
    from mlx_mcmc_tpu.ops.math import WelfordState as JWelford

    count, mean, m2, _ = W.stats_inputs()
    reduce = _welford_pmean_reduce("chains")

    def shard(c, m, s):
        w = reduce(JWelford(c[0], m[0], s[0]))
        return w.count[None], w.mean[None], w.m2[None]

    f = jax.shard_map(shard, mesh=_two_devices_mesh(), in_specs=(P("chains"),) * 3,
                      out_specs=(P("chains"),) * 3)
    ref = [np.asarray(x)[0] for x in jax.jit(f)(jnp.asarray(count), jnp.asarray(mean),
                                                  jnp.asarray(m2))]
    # the exact pooled moments, in float64
    total = count.sum()
    exact_mean = (mean * count[:, None]).sum(0) / total
    exact_m2 = (m2 + count[:, None] * (mean - exact_mean) ** 2).sum(0)
    for rank in (0, 1):
        got, meta = ranks.load("stats", rank)
        for name, r, e in zip(("count", "mean", "m2"), ref, (total, exact_mean, exact_m2)):
            np.testing.assert_allclose(got[name], r, rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(got[name], e, rtol=1e-5, err_msg=name)


def test_rhat_ess_match_reference(ranks):
    from mlx_mcmc_tpu.diagnostics import device_ess as j_ess
    from mlx_mcmc_tpu.diagnostics import device_rhat as j_rhat

    x = W.stats_inputs()[3]
    f = jax.shard_map(
        lambda xs: (j_rhat(xs, axis_name="chains")[None], j_ess(xs, axis_name="chains")[None]),
        mesh=_two_devices_mesh(), in_specs=P("chains"), out_specs=(P("chains"), P("chains")))
    r_ref, e_ref = (np.asarray(v)[0] for v in jax.jit(f)(jnp.asarray(x)))
    # the whole chain set on one device gives the same statistics
    whole = torch.from_numpy(x)
    for rank in (0, 1):
        got, meta = ranks.load("stats", rank)
        np.testing.assert_allclose(got["rhat"], r_ref, rtol=1e-5)
        np.testing.assert_allclose(got["ess"], e_ref, rtol=1e-5)
        np.testing.assert_allclose(got["rhat"], device_rhat(whole).numpy(), rtol=1e-5)
        np.testing.assert_allclose(got["ess"], device_ess(whole).numpy(), rtol=1e-5)
        assert meta["collectives"] == 2 + 4  # Welford: 2 sums; ESS: 4 means


def test_adaptive_sharded_run(ranks):
    # tests/test_parallel.py:26-37 (posterior), 77-90 (one shared metric)
    # and test_diagnostics.py:187 (device R-hat/ESS), at 150 + 300
    got, meta = ranks.load("adaptive", 0)
    xs = got["s_x"].reshape(-1, 3)
    assert np.all(np.abs(xs.mean(axis=0) - 1.0) < 0.2)
    assert np.all(np.abs(xs.std(axis=0) - 2.0) < 0.25)
    assert got["inv_mass"].shape == (3,)
    assert np.all(got["inv_mass"] > 1.0) and np.all(got["inv_mass"] < 12.0)
    assert np.all(got["r_hat"] < 1.05) and np.all(got["n_eff"] > 200)
    draws = torch.from_numpy(got["s_x"])
    np.testing.assert_allclose(got["r_hat"], device_rhat(draws).numpy(), rtol=1e-5)
    np.testing.assert_allclose(got["n_eff"], device_ess_chunked(draws).numpy(), rtol=1e-5)
    # test_parallel.py:92-102: statistically sample()'s
    assert abs(xs.mean() - ranks.refs["adaptive"].mean()) < 0.15
    # one pooled mean a warmup step and the probe's, two sums a window end
    ends = int(build_schedule(W.ADAPTIVE["num_warmup"]).window_end.sum())
    n = meta["collectives"]
    assert n["adaptation"] == meta["probe_evals"] + W.ADAPTIVE["num_warmup"] + 2 * ends
    assert n["diagnostics"] == 3 + 4  # R-hat's three means, one ESS slice's four
    assert n["gather"] > 0


def test_statistically_matches_reference_sample_sharded(ranks):
    xb = ranks.refs["reference_adaptive"].reshape(-1, 3)
    xa = ranks.load("adaptive", 0)[0]["s_x"].reshape(-1, 3)
    assert np.all(np.abs(xa.mean(axis=0) - xb.mean(axis=0)) < 0.15)
    assert np.all(np.abs(xa.std(axis=0) / xb.std(axis=0) - 1.0) < 0.1)


def test_sharded_chees(ranks):
    # tests/test_chees.py:114, cut to 200 + 200
    got, _ = ranks.load("chees", 0)
    xs = got["x"].reshape(-1, 3)
    assert np.all(np.abs(xs.mean(axis=0)) < 0.15)
    assert len(got["counts"]) == W.CHEES["num_warmup"] + W.CHEES["num_samples"]


def test_sharded_through_facade(ranks):
    # tests/test_facade.py:150-185 (NUTS cut to 100 + 100)
    got, meta = ranks.load("facade", 0)
    assert got["nuts_mu"].shape == (8 * W.FACADE["nuts"]["num_samples"],)
    assert abs(got["nuts_mu"].mean() - W.Y.mean()) < 0.3
    assert got["metropolis_mu"].shape == (8 * W.FACADE["metropolis"]["num_samples"],)
    assert abs(got["metropolis_mu"].mean() - W.Y.mean()) < 0.5
    assert 0.0 < meta["nuts_accept"] <= 1.0 and 0.0 < meta["metropolis_accept"] <= 1.0


def test_errors(ranks):
    meta = ranks.load("errors", 0)[1]
    assert meta["indivisible"].startswith("ValueError") and "not divisible" in meta["indivisible"]
    assert "incompatible with device_diagnostics" in meta["chunk_diagnostics"]
    assert meta["data_axis"].startswith("ValueError") and "requires data" in meta["data_axis"]


def test_draw_chunk_bitwise(ranks):
    got, _ = ranks.load("chunk", 0)
    assert str(got["chunk_type"]) == "ndarray"
    np.testing.assert_array_equal(got["s_x"], got["whole_x"])


def test_payload_names_the_mesh_and_refuses_to_resume(ranks):
    # refused without the mesh; resumed on it, the longer run's draws
    for rank in (0, 1):
        got, meta = ranks.load("payload", rank)
        assert meta["mesh_axes"] == {"axis": "chains", "axis_size": 2, "data_axis": None,
                                     "data_axis_size": None}
        assert "mesh layout differs" in meta["resume"]
        np.testing.assert_array_equal(got["rest_x"], got["longer_x"])
        np.testing.assert_array_equal(got["x"], got["last_x"])  # every chain's last draw
        adapt = [v for k, v in got.items() if k.startswith("adapt_")]
        assert adapt and all(a.shape[0] == 2 for a in adapt)  # tiled over the ranks


def test_every_rank_holds_the_global_result(ranks):
    for name in W.SUITES["tier1"]:
        a, meta_a = ranks.load(name, 0)
        b, meta_b = ranks.load(name, 1)
        if name in ("jitter", "payload"):  # each rank's own starts and file
            a.pop("starts", None), b.pop("starts", None)
        assert a.keys() == b.keys(), name
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def test_clear_runner_cache_clears_the_sharded_cache(world_of_one):
    from mlx_mcmc_tpu_torch import clear_runner_cache

    model, dim, kw = W.FIXED["hmc"]
    sample_sharded(model, {"x": torch.zeros(dim)}, **kw)
    assert sharded_mod._SHARDED_CACHE
    clear_runner_cache()
    assert not sharded_mod._SHARDED_CACHE


@pytest.mark.slow
def test_reference_sizes(tmp_path):
    """tests/test_parallel.py, test_diagnostics.py:187, test_chees.py:114
    and test_facade.py:150 at the reference's sizes, on 2 ranks."""
    two_ranks = W.Ranks(tmp_path, "slow")
    want = sample(W.normal_model, {"x": torch.zeros(2)}, **W.ADAPTIVE_REF["vs_sample"][2])
    got, _ = two_ranks.load("adaptive_ref", 0)
    xs = got["recovery_x"].reshape(-1, 3)
    assert np.all(np.abs(xs.mean(axis=0) - 1.0) < 0.2)
    assert np.all(np.abs(xs.std(axis=0) - 2.0) < 0.25)
    assert np.all(got["tunables_inv_mass"] > 1.0) and np.all(got["tunables_inv_mass"] < 12.0)
    assert abs(got["vs_sample_x"].mean() - want.samples["x"].numpy().mean()) < 0.15
    assert np.all(got["diagnostics_r_hat"] < 1.05) and np.all(got["diagnostics_n_eff"] > 200)
    chees, _ = two_ranks.load("chees_ref", 0)
    assert np.all(np.abs(chees["x"].reshape(-1, 3).mean(axis=0)) < 0.15)
    facade, _ = two_ranks.load("facade_ref", 0)
    assert facade["nuts_mu"].shape == (2400,)
    assert abs(facade["nuts_mu"].mean() - W.Y.mean()) < 0.3
