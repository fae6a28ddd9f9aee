"""Port parity: the fused hierarchical Poisson regression (K3) and its model.

Data: the reference's generator (12 groups x 20 counts, K = 2, seed 3), its
pytree carried into the port by ``convert.py`` (E columns and group padding
stripped). Tolerances are those of ``tests/test_pallas_poisson.py``:
- the port's vag against the reference's ``use_pallas=False`` vag:
  ll 3e-5 relative, g 2e-4 relative + 2e-3;
- the port's plain K3 against the reference's Pallas body in interpret mode,
  whose gradient product runs in bf16: ll 2e-5 relative + 1e-3, gradients
  2e-2 relative + 0.5.
Then the density halves of the model factory, the full-data model of
``models/poisson.py`` (both variants) against the reference's, and a small
CPU ``sample()`` that recovers beta. The CUDA kernel against the plain
version: ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.models import make_poisson_event_rates as j_make_rates
from mlx_mcmc_tpu.ops.pallas.poisson import (
    _GROUPS_PER_TILE,
    ROWS_PER_GROUP,
    _assemble_ba,
    _poisson_padded_call,
    _round_up,
)
from mlx_mcmc_tpu.ops.pallas.poisson import make_fused_poisson_vag as j_make_vag
from mlx_mcmc_tpu.ops.pallas.poisson import prepare_fused_poisson_data as j_prepare
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.convert import fused_poisson_data_from_jax, params_from_jax
from mlx_mcmc_tpu_torch.models import make_poisson_event_rates
from mlx_mcmc_tpu_torch.models.poisson import poisson_log_prob
from mlx_mcmc_tpu_torch.ops import poisson
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

G, N_OBS, K = 12, 20, 2


@pytest.fixture(scope="module")
def jspec():
    return j_make_rates(num_groups=G, obs_per_group=N_OBS, covariate_dim=K, seed=3)


@pytest.fixture(scope="module")
def jdata(jspec):
    return j_prepare(jspec.y, jspec.X)


@pytest.fixture(scope="module")
def tdata(jdata):
    return fused_poisson_data_from_jax({k: np.array(v) for k, v in jdata.items()}, device="cpu")


def test_converter_strips_the_tpu_layout(jspec, jdata, tdata):
    assert tdata["X"].shape == (G, N_OBS, K) and tdata["y"].shape == (G, N_OBS)
    assert (tdata["G"], tdata["K"]) == (G, K)
    np.testing.assert_array_equal(tdata["X"].numpy(), np.asarray(jspec.X, np.float32))
    np.testing.assert_array_equal(tdata["y"].numpy(), np.asarray(jspec.y))
    # The port's own packing of the same counts gives the same constants.
    own = poisson.prepare_fused_poisson_data(np.array(jspec.y), np.array(jspec.X), device="cpu")
    np.testing.assert_allclose(own["lamhat"].numpy(), tdata["lamhat"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(own["shat"].numpy(), tdata["shat"].numpy(), rtol=1e-6, atol=1e-7)
    assert own["c0"] == pytest.approx(tdata["c0"], rel=1e-6)


@pytest.mark.parametrize("scales", [(5.0, 1.0), (2.0, 0.5)])
def test_vag_matches_reference_fallback(jdata, tdata, scales):
    rng = np.random.default_rng(0)
    Z = rng.normal(scale=0.3, size=(8, K + 2 + G)).astype(np.float32)
    jvag = j_make_vag(*scales, use_pallas=False)
    ll_j, g_j = jax.vmap(lambda z: jvag(z, jdata))(jnp.asarray(Z))
    ll_t, g_t = poisson.make_fused_poisson_vag(*scales)(torch.from_numpy(Z), tdata)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=3e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=2e-4, atol=2e-3)


def test_plain_kernel_matches_pallas_interpret(jdata, tdata):
    rng = np.random.default_rng(1)
    C = 4
    n_pad, a_pad = jdata["Xa"].shape
    g_pad = n_pad // ROWS_PER_GROUP
    k_pad = _round_up(K, 8)
    n_tiles = g_pad // _GROUPS_PER_TILE
    theta = rng.normal(1.0, 0.5, size=(C, G)).astype(np.float32)
    beta = rng.normal(scale=0.3, size=(C, K)).astype(np.float32)
    c_pad = 128
    theta_t = jnp.zeros((g_pad, c_pad), jnp.float32).at[:G, :C].set(jnp.asarray(theta).T)
    beta_t = jnp.zeros((k_pad, c_pad), jnp.float32).at[:K, :C].set(jnp.asarray(beta).T)
    Ba = _assemble_ba(theta_t, beta_t, k_pad, _GROUPS_PER_TILE, a_pad, c_pad)
    ll_tiles, Ga = _poisson_padded_call(jdata["Xa"], jdata["ym"], Ba, True)
    ll_j = np.asarray(ll_tiles[:, :C]).sum(axis=0)
    Ga = np.asarray(Ga).reshape(n_tiles, a_pad, c_pad)
    gb_j = Ga[:, :K, :C].sum(axis=0).T
    rt_j = Ga[:, k_pad:, :].reshape(g_pad, c_pad)[:G, :C].T

    before = poisson.fused_poisson_vag_cuda.launches
    ll_t, rt_t, gb_t = poisson.fused_poisson_value_and_grad(
        tdata["X"], tdata["y"], tdata["shat"], tdata["lamhat"],
        torch.from_numpy(theta), torch.from_numpy(beta),
    )
    assert poisson.fused_poisson_vag_cuda.launches == before  # CPU: the plain version
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=2e-5, atol=1e-3)
    np.testing.assert_allclose(rt_t.numpy(), rt_j, rtol=2e-2, atol=0.5)
    np.testing.assert_allclose(gb_t.numpy(), gb_j, rtol=2e-2, atol=0.5)


def test_model_factory_halves_agree(jspec, tdata):
    log_prob, vag = poisson.make_fused_poisson_model(prior_mu_scale=2.0, prior_log_tau_scale=0.5)
    params = params_from_jax(jspec.initial_params, device="cpu")
    flat_lp, z0, _ = make_flat_logprob(log_prob, params, data_aware=True, device="cpu")
    z = z0 + 0.2
    ll, _ = vag(z[None], tdata)
    np.testing.assert_allclose(float(ll[0]), float(flat_lp(z, tdata)), rtol=1e-5)


@pytest.mark.parametrize("covariates", [True, False], ids=["regression", "rates"])
def test_full_data_model_matches_reference(jspec, tdata, covariates):
    jspec0 = jspec if covariates else j_make_rates(num_groups=G, obs_per_group=N_OBS, seed=3)
    params = params_from_jax(jspec0.initial_params, device="cpu")
    X = torch.from_numpy(np.array(jspec0.X)) if covariates else None
    t_lp = poisson_log_prob(torch.from_numpy(np.array(jspec0.y)), X)
    t_flp, z0, _ = make_flat_logprob(t_lp, params, device="cpu")
    j_flp, _, _ = j_make_flat_logprob(jspec0.log_prob, jspec0.initial_params)
    Z = np.random.default_rng(2).normal(scale=0.3, size=(5, z0.shape[0])).astype(np.float32)
    j_vals = np.asarray(jax.vmap(j_flp)(jnp.asarray(Z)))
    t_vals = np.array([float(t_flp(torch.from_numpy(z))) for z in Z])
    np.testing.assert_allclose(t_vals, j_vals, rtol=3e-5)
    if covariates:  # autograd of the full-data model against the fused vag
        from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad

        ll_m, g_m = make_batched_value_and_grad(t_flp)(torch.from_numpy(Z))
        ll_f, g_f = poisson.make_fused_poisson_vag()(torch.from_numpy(Z), tdata)
        np.testing.assert_allclose(ll_f.numpy(), ll_m.numpy(), rtol=3e-5)
        np.testing.assert_allclose(g_f.numpy(), g_m.numpy(), rtol=2e-4, atol=2e-3)


def test_generator_and_argument_checks():
    spec = make_poisson_event_rates(7, 9, covariate_dim=3, seed=1, device="cpu")
    assert spec.y.shape == (7, 9) and spec.X.shape == (7, 9, 3)
    assert set(spec.truth) == {"mu", "tau", "theta", "beta"} and spec.truth["beta"].shape == (3,)
    assert spec.truth["theta"].shape == (7,)
    assert bool((spec.y >= 0).all()) and bool((spec.y == spec.y.round()).all())
    rates = make_poisson_event_rates(7, 9, seed=1, device="cpu")
    assert rates.X is None and "beta" not in rates.initial_params
    flp, z0, _ = make_flat_logprob(rates.log_prob, rates.initial_params, device="cpu")
    assert z0.shape == (9,) and torch.isfinite(flp(z0))
    data = poisson.prepare_fused_poisson_data(spec.y, spec.X, device="cpu")
    args = (data["X"], data["y"], data["shat"], data["lamhat"], torch.zeros(2, 7), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        poisson.fused_poisson_vag_cuda(*args)
    with pytest.raises(ValueError, match="columns"):
        poisson.make_fused_poisson_vag()(torch.zeros(2, 5), data)
    with pytest.raises(ValueError, match="expected y"):
        poisson.prepare_fused_poisson_data(spec.y, spec.X[:, :4], device="cpu")


def test_sampling_recovers_beta():
    spec = make_poisson_event_rates(G, N_OBS, covariate_dim=K, seed=3, device="cpu")
    data = poisson.prepare_fused_poisson_data(spec.y, spec.X, device="cpu")
    log_prob, vag = poisson.make_fused_poisson_model()
    res = sample(
        log_prob, spec.initial_params, data=data, value_and_grad_fn=vag,
        num_warmup=200, num_samples=200, num_chains=8, max_tree_depth=6,
        target_accept=0.9, seed=0, device="cpu",
    )
    assert res.samples["beta"].shape == (8, 200, K) and res.samples["theta_raw"].shape == (8, 200, G)
    beta_hat = res.samples["beta"].double().mean(dim=(0, 1))
    np.testing.assert_allclose(beta_hat.numpy(), spec.truth["beta"].numpy(), atol=0.25)
    assert res.divergences == 0 and abs(res.acceptance_rate - 0.9) < 0.05


@pytest.mark.parametrize("g,n", [(1000, 100), (37, 61), (1, 300), (5000, 7), (3, 5000)])
def test_poisson_plan_does_not_depend_on_the_chain_count(g, n):
    # K3's slab of whole groups is set by G, n and the SM count only, so a
    # chain's ll and gradients are summed in one order whatever C is.
    plans = [poisson.launch_plan(g, n, c, 132) for c in (1, 4, 70, 256, 300, 512, 4096)]
    assert len({(p["groups_per_block"], p["splits"]) for p in plans}) == 1
    gpb, splits = plans[0]["groups_per_block"], plans[0]["splits"]
    assert 1 <= gpb <= 16 and splits == -(-g // gpb) and splits * gpb >= g
    assert gpb == 1 or gpb * n <= 1024  # a slab of short groups is staged whole
    assert [p["chain_tiles"] for p in plans] == [-(-c // 256) for c in (1, 4, 70, 256, 300, 512, 4096)]
    if (g, n) == (1000, 100):
        assert (gpb, splits) == (8, 125)  # about one split per SM on an H100
