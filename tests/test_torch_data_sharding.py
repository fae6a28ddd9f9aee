"""The port's observation sharding (``sample_sharded(data_axis=...)``,
``ops.glm``'s ``num_shards``, ``fused_data_specs`` and
``include_prior``) against the reference's oracles
(``tests/test_data_sharding.py``, case for case), against the port's own
replicated ``sample()`` and against the JAX package.

Four ranks of a gloo world on the CPU run every multi-rank scenario in one
session (``tests/_torch_sharding_worker.py``, suite ``data``), started once
for the module; while they run, the tests compute their in-process
counterparts. The ranks lay out as ``data_chain_mesh(2, 2)`` (a chain
group and a data group at once), ``(1, 4)`` and ``(4, 1)``.

- Short runs at fixed tunables (HMC, ChEES, MALA, Metropolis, NUTS on its
  static schedule) match the replicated run at the reference's
  ``rtol=2e-3, atol=2e-4`` (the sum over shards reorders the likelihood's
  sum); the fused protocol through K1's plain twin (four shards, pad rows
  present, f32 and bf16 X) matches the unsharded fused run at ``rtol=1e-5,
  atol=1e-6``.
- Every rank holds the same global result, bit for bit: the ranks of a
  data group hold the same chains and draw and adapt alike.
- At fixed coefficients, the sum over the port's shards of the generic and
  the fused value+grad plus the prior, in this process and through the
  ranks' ``all_reduce``, equals the JAX package's unsharded value and
  gradient to ``rtol=1e-5``.
- An adaptive run is held against the JAX package's
  ``sample_sharded(data_axis='data')`` on ``data_chain_mesh(2, 4)`` of the
  8 virtual devices (means within 0.15, sds within 10%, the bands of
  ``test_torch_parallel.py``). The conjugate-Gaussian recovery is cut to 50
  + 60 and ChEES to 60 + 60 (the reference's sizes under ``-m slow``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel_worker as W
import _torch_sharding_worker as S
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.ops import glm
from mlx_mcmc_tpu_torch.parallel import sharded


def _jax_refs() -> dict:
    """The JAX package's unsharded value and gradient at the fixed
    coefficients (the generic model, and the fused f32 vag with its prior)
    and its sample_sharded of the adaptive scenario."""
    from mlx_mcmc_tpu import Normal as JNormal
    from mlx_mcmc_tpu.models import make_logistic_regression as j_make
    from mlx_mcmc_tpu.ops.pallas.glm import fused_data_specs as j_specs
    from mlx_mcmc_tpu.ops.pallas.glm import make_fused_logistic_vag as j_vag
    from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
    from mlx_mcmc_tpu.parallel import data_chain_mesh as j_mesh
    from mlx_mcmc_tpu.parallel import sample_sharded as j_sample_sharded

    def j_prior(params):
        return jnp.sum(JNormal(0.0, 1.0).log_prob(params["beta"]))

    def j_local(params, data):
        s = jnp.dot(data["X"], params["beta"], preferred_element_type=jnp.float32)
        return jnp.sum(data["y"] * s - jax.nn.softplus(s))

    refs = {}
    spec = j_make(num_features=8, num_obs=64, seed=0)
    data = {"X": spec.X, "y": spec.y}
    full = jax.vmap(jax.value_and_grad(
        lambda b: j_local({"beta": b}, data) + j_prior({"beta": b})))
    refs["generic"] = [np.asarray(t) for t in full(jnp.asarray(S.fixed_beta(8)))]
    fspec = j_make(seed=0, **S.FUSED_SHAPE)
    fvag = jax.vmap(j_vag(data_aware=True, use_pallas=False), in_axes=(0, None))
    refs["fused"] = [np.asarray(t) for t in fvag(jnp.asarray(S.fixed_beta(6)),
                                                 j_prepare(fspec.X, fspec.y, tile_n=8))]
    # the adaptive scenario on the reference's 2 x 4 mesh: the fused
    # protocol, its data prepared for four shards
    jdata = j_prepare(spec.X, spec.y, tile_n=8, num_shards=4)

    def j_value_only(params, d):  # the reference's _fused_value_only
        s = jnp.dot(d["Xp"][:, :8], params["beta"].astype(d["Xp"].dtype),
                    preferred_element_type=jnp.float32)
        return jnp.sum(d["yp"][:, 0] * s - jax.nn.softplus(s)) + d["pad_const"]

    res = j_sample_sharded(
        j_value_only, spec.initial_params, mesh=j_mesh(2, 4), data=jdata,
        data_axis="data", data_specs=j_specs(jdata, "data"), log_prior_fn=j_prior,
        value_and_grad_fn=j_vag(data_aware=True, use_pallas=False, include_prior=False),
        **S.ADAPTIVE)
    refs["adaptive"] = np.asarray(res.samples["beta"])
    return refs


def _refs() -> dict:
    """The in-process counterparts: the port's replicated sample() of each
    scenario and the JAX package's references."""
    spec, data = S.logistic()
    refs = {}
    for kernel, extra in S.SHORT_KERNELS.items():
        res = sample(S.full_model, spec.initial_params, data=data, kernel=kernel, **extra,
                     **S.SHORT)
        refs[kernel] = S.arrays(res)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        fspec, fdata = S.fused_data(dtype, 1)
        res = sample(None, fspec.initial_params, data=fdata,
                     value_and_grad_fn=glm.make_fused_logistic_vag(include_prior=True), **S.FUSED)
        refs[f"fused_{name}"] = S.arrays(res)
    refs["adaptive_port"] = sample(
        None, spec.initial_params, data=glm.prepare_fused_logistic_data(spec.X, spec.y,
                                                                        device="cpu"),
        value_and_grad_fn=glm.make_fused_logistic_vag(), device="cpu",
        **S.ADAPTIVE).samples["beta"].numpy()
    refs.update(_jax_refs())
    return refs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' run, with ``refs`` (:func:`_refs`) computed while it
    runs."""
    four = W.Ranks(tmp_path_factory.mktemp("data_ranks"), "data", world=S.WORLD)
    try:
        four.refs = _refs()
        yield four
    finally:
        four.stop()


def _close(got: dict, want: dict, prefix: str, rtol: float, atol: float) -> None:
    keys = [k for k in got if k.startswith(prefix + "s_")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k[len(prefix):]], rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("kernel", ["hmc", "chees", "mala", "metropolis"])
def test_matches_replicated_short_run(ranks, kernel):
    # tests/test_data_sharding.py:50-81
    got, _ = ranks.load("short", 0)
    _close(got, ranks.refs[kernel], f"{kernel}_", rtol=2e-3, atol=2e-4)


def test_nuts_data_sharded_matches_replicated(ranks):
    # test_data_sharding.py:202-235: the static schedule, forced on the data axis
    got, _ = ranks.load("short", 0)
    _close(got, ranks.refs["nuts"], "nuts_", rtol=2e-3, atol=2e-4)
    assert np.all(got["nuts_i_tree_depth"] <= S.SHORT_KERNELS["nuts"]["max_tree_depth"])


@pytest.mark.parametrize("layout", ["1x4", "4x1"])
def test_every_layout_of_four_ranks(ranks, layout):
    got, _ = ranks.load("short", 0)
    _close(got, ranks.refs["hmc"], f"hmc{layout}_", rtol=2e-3, atol=2e-4)


def test_data_collectives_counted(ranks):
    """One sum over the shards an evaluation: the start's, then HMC's 4
    leapfrogs, one Metropolis or MALA proposal, or the static schedule's
    2^depth - 1 leapfrogs a transition."""
    _, meta = ranks.load("short", 0)
    steps = S.SHORT["num_warmup"] + S.SHORT["num_samples"]
    per_step = {"hmc": 4, "metropolis": 1, "mala": 1,
                "nuts": 2 ** S.SHORT_KERNELS["nuts"]["max_tree_depth"] - 1}
    for kernel, n in per_step.items():
        assert meta["data_collectives"][kernel] == 1 + steps * n, kernel


@pytest.mark.parametrize("x_dtype", ["f32", "bf16"])
def test_fused_vag_data_sharded(ranks, x_dtype):
    # test_data_sharding.py:129-200 through K1's plain twin: likelihood-only
    # shard terms, pad_const divided by the shard count, fused_data_specs
    got, meta = ranks.load("fused", 0)
    assert meta[f"{x_dtype}_rows"] == 64 and meta[f"{x_dtype}_pad_const"] > 0.0  # pad rows
    assert math.isclose(meta[f"{x_dtype}_pad_const"], 2 * math.log(2.0) / 4)
    _close(got, ranks.refs[f"fused_{x_dtype}"], f"{x_dtype}_", rtol=1e-5, atol=1e-6)


def test_hmc_posterior_recovery_with_adaptation(ranks):
    # test_data_sharding.py:83-110, cut to 50 + 60: the summed likelihood
    # is counted once
    n = len(S.Y_CONJ)
    post_var = 1.0 / (n + 1.0 / 100.0)
    post_mean = post_var * S.Y_CONJ.sum()
    draws = ranks.load("recovery", 0)[0]["mu"].ravel()
    assert abs(draws.mean() - post_mean) < 4 * np.sqrt(post_var)
    assert abs(draws.std() - np.sqrt(post_var)) < 0.5 * np.sqrt(post_var)


def test_chees_data_sharded_2d_mesh(ranks):
    # test_data_sharding.py:112-127, cut to 60 + 60
    got, _ = ranks.load("chees_2d", 0)
    beta = got["beta"]
    assert np.isfinite(beta).all()
    assert len(got["counts"]) == S.CHEES["num_warmup"] + S.CHEES["num_samples"]
    spec, _ = S.logistic()
    err = np.abs(beta.reshape(-1, 8).mean(axis=0) - spec.true_beta.numpy())
    assert err.mean() < 1.0


def test_shard_sums_match_jax(ranks):
    """The sum over the port's shards plus the prior, in this process
    (``shard_data`` and the local value+grads) and through the ranks'
    ``all_reduce``, against the JAX package's unsharded value+grad."""
    got, _ = ranks.load("value_grad", 0)
    assert int(got["generic_rows"]) == 16
    for rank in range(S.WORLD):
        other, _ = ranks.load("value_grad", rank)
        for k in got:
            np.testing.assert_array_equal(other[k], got[k], err_msg=f"rank {rank} {k}")
    jv, jg = ranks.refs["generic"]
    np.testing.assert_allclose(got["generic_v"], jv, rtol=1e-5)
    np.testing.assert_allclose(got["generic_g"], jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())
    fv, fg = ranks.refs["fused"]
    np.testing.assert_allclose(got["f32_v"], fv, rtol=1e-5)
    np.testing.assert_allclose(got["f32_g"], fg, rtol=1e-5, atol=1e-5 * np.abs(fg).max())
    assert int(got["f32_count"]) == 1
    # in this process: the shards' local terms summed, then the prior
    Z = torch.from_numpy(S.fixed_beta(6))
    _, fdata = S.fused_data(torch.float32, 4)
    local = glm.make_fused_logistic_vag(include_prior=False)
    parts = [local(Z, sharded.shard_data(fdata, glm.fused_data_specs(fdata), r, 4))
             for r in range(4)]
    v = sum(p[0] for p in parts) - 0.5 * (Z * Z).sum(-1) - 3 * math.log(2 * math.pi)
    g = sum(p[1] for p in parts) - Z
    np.testing.assert_allclose(v.numpy(), fv, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), fg, rtol=1e-5, atol=1e-5 * np.abs(fg).max())
    # the bf16 shards against the port's unsharded bf16 vag (the plain twin
    # rounds Z and the residual to bf16, where the JAX reference path does not)
    _, bdata = S.fused_data(torch.bfloat16, 1)
    bv, bg = glm.make_fused_logistic_vag()(Z, bdata)
    np.testing.assert_allclose(got["bf16_v"], bv.numpy(), rtol=1e-5)
    assert np.abs(got["bf16_g"] - bg.numpy()).max() <= 1e-4 * np.abs(bg.numpy()).max() + 1e-5


def test_statistically_matches_jax_sample_sharded(ranks):
    xa = ranks.load("adaptive", 0)[0]["beta"].reshape(-1, 8)
    for ref in ("adaptive", "adaptive_port"):
        xb = ranks.refs[ref].reshape(-1, 8)
        assert np.all(np.abs(xa.mean(axis=0) - xb.mean(axis=0)) < 0.15), ref
        assert np.all(np.abs(xa.std(axis=0) / xb.std(axis=0) - 1.0) < 0.1), ref


def test_data_sharded_chunked(ranks):
    # test_sharded_resume.py:116-141: chunks compose with the data axis
    got, _ = ranks.load("chunked", 0)
    assert isinstance(got["chunked"], np.ndarray)
    np.testing.assert_array_equal(got["full"], got["chunked"])


@pytest.mark.parametrize("case,error,text", [
    ("dynamic_nuts", "ValueError", "static"),  # test_data_sharding.py:237-251
    ("requires_data", "ValueError", "requires data"),  # :253-262
    ("unknown_axis", "ValueError", "not in mesh axes"),  # :264-274
    ("prior_without_axis", "ValueError", "pass data_axis"),
])
def test_errors(ranks, case, error, text):
    message = ranks.load("data_errors", 0)[1][case]
    assert message.startswith(error) and text in message, message


def test_data_peers_bit_identical(ranks):
    """The ranks of a data group hold the same chains and draw, adapt and
    gather alike: every rank's global result is rank 0's, bit for bit."""
    for name in ("short", "fused", "recovery", "chees_2d", "adaptive", "chunked"):
        a, meta_a = ranks.load(name, 0)
        for rank in range(1, S.WORLD):
            b, meta_b = ranks.load(name, rank)
            assert a.keys() == b.keys(), name
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} rank {rank} {k}")


def test_num_shards_pads_rows_and_divides_constants():
    """``num_shards`` pads the rows with zeros to a multiple of the shard
    count and divides the constants every shard adds (the reference's
    ``glm.py:426-427, 528-536``); int8 scales come from all of X."""
    rng = np.random.default_rng(3)
    X = torch.from_numpy(rng.normal(size=(61, 5)).astype(np.float32))
    y = torch.from_numpy((rng.random(61) < 0.5).astype(np.float32))
    data = glm.prepare_fused_logistic_data(X, y, num_shards=3, device="cpu")
    assert data["Xp"].shape == (63, 16) and data["XpT"].shape == (16, 64)
    assert math.isclose(data["pad_const"], 2 * math.log(2.0) / 3)
    assert not data["Xp"][61:].any() and not data["yp"][61:].any()
    one = glm.prepare_fused_logistic_data(X, y, device="cpu")
    assert one["pad_const"] == 0.0 and one["Xp"].shape[0] == 61
    q3 = glm.prepare_fused_logistic_data(X, y, quantize="int8", num_shards=3, device="cpu")
    q1 = glm.prepare_fused_logistic_data(X, y, quantize="int8", device="cpu")
    assert torch.equal(q3["col_scale"], q1["col_scale"])
    assert torch.equal(q3["Xp"][:61], q1["Xp"])
    lin = glm.prepare_fused_linear_data(X, y, noise_scale=2.0, num_shards=3, device="cpu")
    assert math.isclose(lin["ll_norm"], -0.5 * 61 * math.log(2 * math.pi * 4.0) / 3)
    # the shards' sum is the whole likelihood, whichever way it is padded
    Z = torch.from_numpy(rng.normal(size=(4, 5)).astype(np.float32))
    vag = glm.make_fused_logistic_vag(include_prior=False)
    whole = vag(Z, one)
    parts = [vag(Z, sharded.shard_data(data, glm.fused_data_specs(data), r, 3))
             for r in range(3)]
    np.testing.assert_allclose(sum(p[0] for p in parts).numpy(), whole[0].numpy(), rtol=1e-5)
    np.testing.assert_allclose(sum(p[1] for p in parts).numpy(), whole[1].numpy(), rtol=1e-5,
                               atol=1e-5)
    lvag = glm.make_fused_linear_vag(include_prior=False)
    lin1 = glm.prepare_fused_linear_data(X, y, noise_scale=2.0, device="cpu")
    lparts = [lvag(Z, sharded.shard_data(lin, glm.fused_data_specs(lin), r, 3)) for r in range(3)]
    np.testing.assert_allclose(sum(p[0] for p in lparts).numpy(), lvag(Z, lin1)[0].numpy(),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        sharded.shard_data(one, glm.fused_data_specs(one), 0, 3)


def test_include_prior_false_matches_jax():
    """``make_fused_logistic_vag(include_prior=False)`` against the JAX
    package's at the same coefficients (the likelihood terms only,
    ``pad_const`` included)."""
    from mlx_mcmc_tpu.ops.pallas.glm import make_fused_logistic_vag as j_vag
    from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare

    spec, _ = S.logistic(**S.FUSED_SHAPE)
    Z = S.fixed_beta(6)
    jdata = j_prepare(jnp.asarray(spec.X.numpy()), jnp.asarray(spec.y.numpy()), tile_n=8)
    assert float(jdata["pad_const"]) > 0.0  # the reference pads 62 rows to 64
    for include in (False, True):
        f = jax.vmap(j_vag(data_aware=True, use_pallas=False, include_prior=include),
                     in_axes=(0, None))
        jv, jg = (np.asarray(t) for t in f(jnp.asarray(Z), jdata))
        v, g = glm.make_fused_logistic_vag(include_prior=include)(
            torch.from_numpy(Z), glm.prepare_fused_logistic_data(spec.X, spec.y, device="cpu"))
        np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-5, atol=1e-5 * np.abs(jg).max())


def test_default_specs_follow_the_reference():
    from torch.distributed.tensor import Replicate, Shard

    data = {"X": torch.zeros(8, 3), "y": torch.zeros(8), "w": torch.zeros(3),
            "c": torch.tensor(1.0)}
    with pytest.warns(UserWarning, match="replicating"):
        specs = sharded.default_data_specs(data, 4)
    assert specs == {"X": Shard(0), "y": Shard(0), "w": Replicate(), "c": Replicate()}
    fused = glm.prepare_fused_logistic_data(torch.zeros(8, 3), torch.zeros(8), device="cpu")
    assert sharded.default_data_specs(fused, 4) == glm.fused_data_specs(fused)
    part = sharded.shard_data(data, specs, 1, 4)
    assert part["X"].shape == (2, 3) and part["w"] is data["w"]


@pytest.mark.slow
def test_reference_sizes(tmp_path):
    """test_data_sharding.py:83-127 at the reference's sizes, on 4 ranks."""
    four = W.Ranks(tmp_path, "data_slow", world=S.WORLD)
    n = len(S.Y_CONJ)
    post_var = 1.0 / (n + 1.0 / 100.0)
    draws = four.load("recovery_ref", 0)[0]["mu"].ravel()
    assert abs(draws.mean() - post_var * S.Y_CONJ.sum()) < 4 * np.sqrt(post_var)
    assert abs(draws.std() - np.sqrt(post_var)) < 0.5 * np.sqrt(post_var)
    spec, _ = S.logistic()
    beta = four.load("chees_ref", 0)[0]["beta"]
    assert np.abs(beta.reshape(-1, 8).mean(axis=0) - spec.true_beta.numpy()).mean() < 1.0
