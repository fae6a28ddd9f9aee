"""Port parity: the sufficient-statistic collapse (``ops/suffstats.py``).

Mirrors ``tests/test_suffstats.py``. The reference's and the port's
statistics, value+grads and log-probs get the same numpy-seeded positions
(the reference's data reach the port through ``convert.py``):

- statistics: ``ybar`` within the rounding bound of a float32 sum of its n
  terms, ``n 2^-24 max|y|`` (the port's float32 reductions run in another
  order than XLA's), ``S`` exactly (sums of small integers), ``c0`` to 1e-6
  relative (the port sums in another order, the Poisson one in float64);
- value and gradient against the reference's to float32 tolerance (1e-6
  relative on the value, whose size is set by ``c0``; 1e-5 of the
  gradient's largest element), and both against torch autograd of the
  full-data model (the reference's own bounds: 2e-5 / 3e-5 relative on the
  value, 2e-4 relative + 2e-3 on the gradient);
- a run of hier1000's model at G = 20 through ``sample()`` against the
  reference's posterior means of mu and log_tau within 5 combined Monte
  Carlo standard errors and its sds within 15%.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu import sample as j_sample
from mlx_mcmc_tpu.models import make_hierarchical_normal as j_make_hier
from mlx_mcmc_tpu.models import make_poisson_event_rates as j_make_poisson
from mlx_mcmc_tpu.ops import suffstats as j_ss
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.convert import (
    hier_normal_data_from_jax,
    params_from_jax,
    poisson_rates_data_from_jax,
)
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.models import make_hierarchical_normal, make_poisson_event_rates
from mlx_mcmc_tpu_torch.ops import suffstats
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

GROUPS = [7, 20, 37]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _positions(g, scale, seed=0, chains=16):
    return np.random.default_rng(seed).normal(scale=scale, size=(chains, g + 2)).astype(np.float32)


def _check_vag(tvag, tdata, jvag, jdata, Z):
    ll_j, g_j = jax.vmap(lambda z: jvag(z, jdata))(jnp.asarray(Z))
    ll_t, g_t = tvag(torch.from_numpy(Z), tdata)
    assert ll_t.shape == (Z.shape[0],) and g_t.shape == Z.shape
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-6)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0, atol=1e-5 * np.abs(g_j).max())
    return ll_t, g_t


def _check_autograd(spec_log_prob, init, ll, g, Z, rtol_ll):
    flp, _, _ = make_flat_logprob(spec_log_prob, init, device="cpu")
    ll_a, g_a = make_batched_value_and_grad(flp)(torch.from_numpy(Z))
    np.testing.assert_allclose(ll.numpy(), ll_a.numpy(), rtol=rtol_ll)
    np.testing.assert_allclose(g.numpy(), g_a.numpy(), rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("g", GROUPS)
def test_hier_normal_data_matches_reference(g):
    j_spec = j_make_hier(num_groups=g, obs_per_group=20, seed=3)
    t_spec = make_hierarchical_normal(num_groups=g, obs_per_group=20, seed=3, device="cpu")
    for noise in (1.0, 1.5):
        ref = _np(j_ss.prepare_hier_normal_data(j_spec.y, noise_scale=noise))
        got = suffstats.prepare_hier_normal_data(t_spec.y, noise_scale=noise, device="cpu")
        # the rounding bound of a float32 sum of n terms: n * 2^-24 * max|y|
        bound = 20 * 2.0**-24 * float(np.abs(np.asarray(j_spec.y)).max())
        np.testing.assert_allclose(got["ybar"].numpy(), ref["ybar"], rtol=0, atol=bound)
        np.testing.assert_allclose(got["c0"], float(ref["c0"]), rtol=1e-6)
        assert got["n_per_group"] == float(ref["n_per_group"]) == 20.0
        assert got["inv_noise_var"] == pytest.approx(float(ref["inv_noise_var"]), rel=1e-7)


@pytest.mark.parametrize("g", GROUPS)
def test_hier_normal_vag_matches_reference_and_autograd(g):
    j_spec = j_make_hier(num_groups=g, obs_per_group=20, seed=3)
    t_spec = make_hierarchical_normal(num_groups=g, obs_per_group=20, seed=3, device="cpu")
    jdata = j_ss.prepare_hier_normal_data(j_spec.y)
    tdata = hier_normal_data_from_jax(_np(jdata), device="cpu")
    Z = _positions(g, 0.7)
    ll, grad = _check_vag(suffstats.make_hier_normal_vag(), tdata, j_ss.make_hier_normal_vag(),
                          jdata, Z)
    _check_autograd(t_spec.log_prob, t_spec.initial_params, ll, grad, Z, 2e-5)
    # the port's own statistics give the same values
    own = suffstats.prepare_hier_normal_data(t_spec.y, device="cpu")
    ll_own, _ = suffstats.make_hier_normal_vag()(torch.from_numpy(Z), own)
    np.testing.assert_allclose(ll_own.numpy(), ll.numpy(), rtol=1e-6)


@pytest.mark.parametrize("scales", [(5.0, 1.0), (2.0, 0.5)])
def test_hier_normal_model_halves_agree(scales):
    spec = make_hierarchical_normal(num_groups=12, obs_per_group=20, seed=3, device="cpu")
    data = suffstats.prepare_hier_normal_data(spec.y, device="cpu")
    log_prob, vag = suffstats.make_hier_normal_model(*scales)
    flp, z0, _ = make_flat_logprob(log_prob, spec.initial_params, data_aware=True, device="cpu")
    z = z0 + 0.25
    ll, _ = vag(z[None], data)
    np.testing.assert_allclose(float(ll[0]), float(flp(z, data)), rtol=1e-6)
    # the reference's value twin at the same scales
    jdata = j_ss.prepare_hier_normal_data(j_make_hier(num_groups=12, obs_per_group=20, seed=3).y)
    j_lp = functools.partial(j_ss.hier_suffstat_log_prob, prior_mu_scale=scales[0],
                             prior_log_tau_scale=scales[1])
    params = {"mu": 0.25, "log_tau": 0.25, "theta_raw": jnp.full(12, 0.25)}
    np.testing.assert_allclose(float(flp(z, hier_normal_data_from_jax(_np(jdata), device="cpu"))),
                               float(j_lp(params, jdata)), rtol=1e-6)
    assert vag.graph_safe and log_prob.graph_safe


@pytest.mark.parametrize("g", GROUPS)
def test_poisson_rates_data_matches_reference(g):
    j_spec = j_make_poisson(num_groups=g, obs_per_group=20, seed=7)
    t_spec = make_poisson_event_rates(num_groups=g, obs_per_group=20, seed=7, device="cpu")
    ref = _np(j_ss.prepare_poisson_rates_data(j_spec.y))
    got = suffstats.prepare_poisson_rates_data(t_spec.y, device="cpu")
    np.testing.assert_array_equal(got["S"].numpy(), ref["S"])  # sums of small integers
    np.testing.assert_allclose(got["c0"], float(ref["c0"]), rtol=1e-6)
    assert got["n_per_group"] == 20.0


@pytest.mark.parametrize("g", GROUPS)
def test_poisson_rates_vag_matches_reference_and_autograd(g):
    j_spec = j_make_poisson(num_groups=g, obs_per_group=20, seed=7)
    t_spec = make_poisson_event_rates(num_groups=g, obs_per_group=20, seed=7, device="cpu")
    jdata = j_ss.prepare_poisson_rates_data(j_spec.y)
    tdata = poisson_rates_data_from_jax(_np(jdata), device="cpu")
    log_prob, vag = suffstats.make_poisson_rates_model()
    Z = _positions(g, 0.4)
    ll, grad = _check_vag(vag, tdata, j_ss.make_poisson_rates_model()[1], jdata, Z)
    _check_autograd(t_spec.log_prob, t_spec.initial_params, ll, grad, Z, 3e-5)
    flp, _, _ = make_flat_logprob(log_prob, t_spec.initial_params, data_aware=True, device="cpu")
    np.testing.assert_allclose(float(flp(torch.from_numpy(Z[0]), tdata)), float(ll[0]), rtol=1e-6)
    assert vag.graph_safe and log_prob.graph_safe


def _moments(draws):
    draws = np.asarray(draws, np.float64)  # (chains, draws)
    sd = draws.std()
    return draws.mean(), sd, sd / np.sqrt(float(effective_sample_size(draws[..., None])[0]))


def test_hier_suffstat_run_matches_reference_posterior():
    """hier1000's model (sufficient statistics, non-centered) at G = 20."""
    run = dict(num_chains=32, num_warmup=300, num_samples=400, max_tree_depth=10,
               target_accept=0.8)
    j_spec = j_make_hier(num_groups=20, obs_per_group=100, seed=0)
    jdata = j_ss.prepare_hier_normal_data(j_spec.y)
    jres = j_sample(j_ss.hier_suffstat_log_prob, j_spec.initial_params, data=jdata,
                    value_and_grad_fn=j_ss.make_hier_normal_vag(), seed=0, **run)
    t_spec = make_hierarchical_normal(num_groups=20, obs_per_group=100, seed=0, device="cpu")
    tdata = suffstats.prepare_hier_normal_data(t_spec.y, device="cpu")
    log_prob, vag = suffstats.make_hier_normal_model()
    tres = sample(log_prob, params_from_jax(j_spec.initial_params, device="cpu"), data=tdata,
                  value_and_grad_fn=vag, seed=0, device="cpu", **run)
    assert tres.samples["theta_raw"].shape == (32, 400, 20)
    assert tres.divergences <= 0.01 * 32 * 400
    for name in ("mu", "log_tau"):
        m_j, sd_j, se_j = _moments(jres.samples[name])
        m_t, sd_t, se_t = _moments(tres.samples[name].numpy())
        assert abs(m_t - m_j) <= 5 * np.hypot(se_t, se_j), (name, m_t, m_j)
        assert abs(sd_t / sd_j - 1) <= 0.15, (name, sd_t, sd_j)
    assert abs(tres.acceptance_rate - 0.8) <= 0.05
