"""ADVI (``inference/vi.py``) against the reference's ``tests/test_vi.py``:
exact-Gaussian recovery, ELBO ascent, transformed models, the full-rank
family and ``init_strategy='advi'``.

Beyond the reference's ten cases:
- the negative ELBO and its gradient, from the same variational
  parameters and the same numpy normals, equal the reference's formula in
  JAX (``stop_gradient`` where the port detaches, the same ``build_L``)
  within float32 rounding: rtol 1e-5, atol 1e-5;
- on a Gaussian target, where sticking the landing converges exactly, the
  port's mean-field q equals the reference's within 1e-4, though the two
  draw their normals from different streams;
- the fit's Philox draws come from rows that no sampling step, probe,
  jitter or MAP jitter uses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu import Normal as JNormal
from mlx_mcmc_tpu import fit_advi as j_fit_advi
from mlx_mcmc_tpu_torch import HalfNormal, Normal, fit_advi, sample
from mlx_mcmc_tpu_torch.inference import vi
from mlx_mcmc_tpu_torch.inference.engine import _PROBE_STEP, JITTER_STEP, vmap_log_prob
from mlx_mcmc_tpu_torch.inference.init_strategies import MAP_JITTER_STEP
from mlx_mcmc_tpu_torch.inference.vi import advi_initialize, fit_advi_flat
from mlx_mcmc_tpu_torch.ops.random import step_draws
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

CPU = dict(device="cpu")


class TestADVIExactGaussian:
    """On a Gaussian target the mean-field family holds the truth: ADVI
    recovers loc and scale, as the reference does."""

    def test_recovers_mean_and_scale(self):
        loc, scale = [1.5, -2.0], [0.5, 3.0]

        def log_prob(params):
            return torch.sum(Normal(torch.tensor(loc), torch.tensor(scale)).log_prob(params["x"]))

        res = fit_advi(log_prob, {"x": torch.zeros(2)}, num_steps=1500, seed=0,
                       learning_rate=0.05, **CPU)
        np.testing.assert_allclose(res.mu.numpy(), loc, atol=0.15)
        np.testing.assert_allclose(np.exp(res.log_sigma.numpy()), scale, rtol=0.15)
        ref = j_fit_advi(
            lambda p: jnp.sum(JNormal(jnp.asarray(loc), jnp.asarray(scale)).log_prob(p["x"])),
            {"x": jnp.zeros(2)}, num_steps=1500, seed=0, learning_rate=0.05)
        np.testing.assert_allclose(res.mu.numpy(), np.asarray(ref.mu), atol=1e-4)
        np.testing.assert_allclose(res.log_sigma.numpy(), np.asarray(ref.log_sigma), atol=1e-4)

    def test_elbo_ascends_to_zero_kl(self):
        def log_prob(params):
            return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))

        res = fit_advi(log_prob, {"x": torch.zeros(3)}, num_steps=1200, seed=1, **CPU)
        early = float(res.elbo_trace[:20].mean())
        assert res.elbo > early  # ascent
        assert abs(res.elbo) < 0.05  # KL(q || p) ~ 0 at the optimum

    def test_sample_posterior_moments(self):
        def log_prob(params):
            return torch.sum(Normal(2.0, 0.7).log_prob(params["x"]))

        res = fit_advi(log_prob, {"x": 0.0}, num_steps=1500, seed=2, **CPU)
        draws = res.sample_posterior(seed=3, num_samples=8000)["x"]
        assert draws.shape == (8000,)
        assert abs(float(draws.mean()) - 2.0) < 0.1
        assert abs(float(draws.std()) - 0.7) < 0.1

    def test_summary_keys(self):
        def log_prob(params):
            return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))

        res = fit_advi(log_prob, {"x": torch.zeros(2)}, num_steps=200, seed=0, **CPU)
        s = res.summary(num_samples=500)
        assert set(s) == {"x[0]", "x[1]"}
        for v in s.values():
            assert {"mean", "std", "median", "2.5%", "97.5%"} <= set(v)


class TestADVITransformedAndData:
    def test_halfnormal_scale_with_log_transform(self):
        rng = np.random.default_rng(0)
        data_np = rng.normal(5.0, 2.0, size=200).astype(np.float32)

        def log_prob(params, data):
            lp = Normal(0.0, 10.0).log_prob(params["mu"])
            lp = lp + HalfNormal(5.0).log_prob(params["sigma"])
            return lp + torch.sum(Normal(params["mu"], params["sigma"]).log_prob(data))

        res = fit_advi(log_prob, {"mu": 0.0, "sigma": 1.0}, num_steps=2000, seed=0,
                       data=torch.from_numpy(data_np), transforms={"sigma": "log"}, **CPU)
        draws = res.sample_posterior(seed=1, num_samples=4000)
        assert float(draws["sigma"].min()) > 0.0  # constrained space
        assert abs(float(draws["mu"].mean()) - data_np.mean()) < 0.15
        assert abs(float(draws["sigma"].mean()) - data_np.std()) < 0.3

    def test_nonfinite_draws_do_not_poison_fit(self):
        # Sampling a positive-support model unconstrained: some draws land
        # at s <= 0, where the log density is -inf; their gradients count
        # as 0 instead of poisoning Adam's moments.
        def log_prob(params):
            return HalfNormal(1.0).log_prob(params["s"])

        flat_lp, z0, _ = make_flat_logprob(log_prob, {"s": 1.0}, device="cpu")
        mu, log_sigma, elbo = fit_advi_flat(flat_lp, z0, 0, num_steps=300)
        assert bool(torch.isfinite(mu).all()) and bool(torch.isfinite(log_sigma).all())
        assert not bool(torch.isfinite(elbo).all())  # some draws did leave the support


class TestADVIInitStrategy:
    def test_advi_initialize_shapes_and_support(self):
        def log_prob(params):
            return torch.sum(Normal(3.0, 0.5).log_prob(params["x"]))

        flat_lp, z0, _ = make_flat_logprob(log_prob, {"x": torch.zeros(4)}, device="cpu")
        z0_batch = z0.expand(8, 4).contiguous()
        starts, inv_mass = advi_initialize(flat_lp, z0_batch, 0, num_steps=600)
        assert starts.shape == (8, 4) and inv_mass.shape == (4,)
        # starts near the target mean, metric near the target variance
        assert abs(float(starts.mean()) - 3.0) < 0.5
        np.testing.assert_allclose(inv_mass.numpy(), 0.25, rtol=0.6)
        # each chain's start: q's draw at its own row
        eps = step_draws(0, vi.DRAW_ROW + torch.arange(8), vi.INIT_DRAW_STEP, 4, 0)[0]
        mu, log_sigma, _ = fit_advi_flat(flat_lp, z0, 0, num_steps=600)
        torch.testing.assert_close(starts, mu + torch.exp(log_sigma) * eps, rtol=0, atol=0)

    def test_sample_with_advi_init_recovers_posterior(self):
        rng = np.random.default_rng(42)
        data_t = torch.from_numpy(rng.normal(5.0, 2.0, size=100).astype(np.float32))

        def log_prob(params):
            lp = Normal(0.0, 10.0).log_prob(params["mu"])
            lp = lp + HalfNormal(5.0).log_prob(params["sigma"])
            return lp + torch.sum(Normal(params["mu"], params["sigma"]).log_prob(data_t))

        res = sample(log_prob, {"mu": 0.0, "sigma": 1.0}, num_samples=400, num_warmup=400,
                     num_chains=4, kernel="nuts", seed=0, max_tree_depth=6,
                     transforms={"sigma": "log"}, init_strategy="advi", **CPU)
        mu_draws = res.samples["mu"].numpy().ravel()
        sigma_draws = res.samples["sigma"].numpy().ravel()
        assert abs(mu_draws.mean() - float(data_t.mean())) < 0.2
        assert abs(sigma_draws.mean() - float(data_t.std(unbiased=False))) < 0.4
        assert (sigma_draws > 0).all()


class TestFullRankADVI:
    def test_recovers_correlation_meanfield_cannot(self):
        rho = 0.9
        prec = torch.from_numpy(np.linalg.inv([[1.0, rho], [rho, 1.0]]).astype(np.float32))

        def log_prob(params):
            x = params["x"]
            return -0.5 * x @ prec @ x

        mf = fit_advi(log_prob, {"x": torch.zeros(2)}, num_steps=1500, seed=0, **CPU)
        fr = fit_advi(log_prob, {"x": torch.zeros(2)}, num_steps=2500, seed=0,
                      method="fullrank", **CPU)
        mf_draws = mf.sample_posterior(seed=1, num_samples=6000)["x"].numpy()
        fr_draws = fr.sample_posterior(seed=1, num_samples=6000)["x"].numpy()
        # mean-field shrinks: marginal sd ~ sqrt(1 - rho^2) = 0.44
        assert mf_draws.std(axis=0).max() < 0.7
        # full-rank holds the truth: sd ~ 1, correlation ~ rho
        np.testing.assert_allclose(fr_draws.std(axis=0), 1.0, rtol=0.15)
        assert np.corrcoef(fr_draws.T)[0, 1] > 0.75
        assert fr.elbo > mf.elbo + 0.1  # less KL to the target
        # q's covariance is the target's: Adam's last iterate keeps some
        # noise in the off-diagonal (6e-4 here; the reference's 1.5e-4)
        L = fr.scale_tril.numpy()
        np.testing.assert_allclose(L @ L.T, [[1.0, rho], [rho, 1.0]], atol=2e-3)

    def test_fullrank_transformed_and_validation(self):
        def log_prob(params):
            return HalfNormal(2.0).log_prob(params["s"])

        res = fit_advi(log_prob, {"s": 1.0}, num_steps=800, seed=0, method="fullrank",
                       transforms={"s": "log"}, **CPU)
        draws = res.sample_posterior(seed=1, num_samples=2000)["s"].numpy()
        assert (draws > 0).all()
        with pytest.raises(ValueError):
            fit_advi(log_prob, {"s": 1.0}, method="bogus", **CPU)


# --- the estimator against the reference's formula --------------------------

_LOC = np.array([0.3, -1.0, 2.0], np.float32)
_SCALE = np.array([0.7, 1.5, 0.4], np.float32)


def _t_lp(z):
    return Normal(torch.from_numpy(_LOC), torch.from_numpy(_SCALE)).log_prob(z).sum(-1)


def _j_lp(z):
    return JNormal(jnp.asarray(_LOC), jnp.asarray(_SCALE)).log_prob(z).sum(-1)


def _j_meanfield(var_params, eps):
    """The reference's ``neg_elbo`` (``mlx_mcmc_tpu/inference/vi.py:83-99``)."""
    mu, log_sigma = var_params
    z = mu + jnp.exp(log_sigma) * eps
    mu_s, ls_s = jax.lax.stop_gradient(mu), jax.lax.stop_gradient(log_sigma)
    logq = jnp.sum(-0.5 * ((z - mu_s) * jnp.exp(-ls_s)) ** 2 - ls_s
                   - 0.5 * float(np.log(2 * np.pi)), axis=-1)
    return -jnp.mean(_j_lp(z) - logq)


def _j_fullrank(var_params, eps):
    """The reference's full-rank ``neg_elbo`` and ``build_L``
    (``mlx_mcmc_tpu/inference/vi.py:175-204``)."""
    mu, raw_diag, raw_off = var_params
    dim = mu.shape[0]
    L = jnp.zeros((dim, dim), jnp.float32).at[jnp.tril_indices(dim)].set(raw_off)
    L = L.at[jnp.arange(dim), jnp.arange(dim)].set(jax.nn.softplus(raw_diag))
    z = mu + eps @ L.T
    mu_s, L_s = jax.lax.stop_gradient(mu), jax.lax.stop_gradient(L)
    y = jax.scipy.linalg.solve_triangular(L_s, (z - mu_s).T, lower=True).T
    logq = (-0.5 * jnp.sum(y**2, axis=-1) - jnp.sum(jnp.log(jnp.diag(L_s)))
            - 0.5 * dim * float(np.log(2 * np.pi)))
    return -jnp.mean(_j_lp(z) - logq)


@pytest.mark.parametrize("method", ["meanfield", "fullrank"])
def test_neg_elbo_and_gradient_match_reference_formula(method):
    rng = np.random.default_rng(7)
    eps = rng.normal(size=(8, 3)).astype(np.float32)
    if method == "meanfield":
        params = [rng.normal(size=3).astype(np.float32),
                  rng.normal(scale=0.3, size=3).astype(np.float32)]
        t_fn, j_fn = vi.meanfield_neg_elbo, _j_meanfield
    else:
        params = [rng.normal(size=3).astype(np.float32),
                  rng.normal(scale=0.3, size=3).astype(np.float32),
                  rng.normal(scale=0.3, size=6).astype(np.float32)]
        t_fn, j_fn = vi.fullrank_neg_elbo, _j_fullrank
    leaves = [torch.from_numpy(p).requires_grad_(True) for p in params]
    loss = t_fn(_t_lp, *leaves, torch.from_numpy(eps))
    grads = torch.autograd.grad(loss, leaves)
    j_loss, j_grads = jax.jit(jax.value_and_grad(j_fn))([jnp.asarray(p) for p in params],
                                                        jnp.asarray(eps))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5, atol=1e-5)
    for g, jg in zip(grads, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)


def test_fit_draws_from_rows_no_sampling_run_uses():
    flat_lp, z0, _ = make_flat_logprob(
        lambda p: Normal(0.0, 1.0).log_prob(p["x"]).sum(), {"x": torch.zeros(3)}, device="cpu")
    seed, m, dim = 5, 8, 3
    # the fit's first step takes the normals at rows FIT_ROW + m, step 0
    _, _, elbo = fit_advi_flat(flat_lp, z0, seed, num_steps=1, num_mc_samples=m)
    eps = step_draws(seed, vi.FIT_ROW + torch.arange(m), 0, dim, 0)[0]
    want = -vi.meanfield_neg_elbo(vmap_log_prob(flat_lp), z0, torch.full((dim,), -1.0), eps)
    assert float(elbo[0]) == float(want)
    chains = torch.arange(m)
    for t in (0, 1, 7):
        fit_eps = step_draws(seed, vi.FIT_ROW + chains, t, dim, 0)[0]
        for step in (t, _PROBE_STEP, JITTER_STEP, MAP_JITTER_STEP):
            other = step_draws(seed, chains, step, dim, 0)[0]
            assert not bool((fit_eps == other).any(dim=1).any())
    draws = step_draws(seed, vi.DRAW_ROW + chains, vi.INIT_DRAW_STEP, dim, 0)[0]
    assert not bool((draws == step_draws(seed, chains, vi.INIT_DRAW_STEP, dim, 0)[0]).any())


def test_advi_needs_the_log_density_and_a_device():
    # The log density comes from log_prob_fn or from a fused
    # value_and_grad_fn alone: the fit takes only grad log p at its draws,
    # one value+grad call a step at num_mc_samples rows, and one more call
    # at every chain checks the starts.
    shapes = []

    def vag(Z):
        shapes.append(tuple(Z.shape))
        return -0.5 * ((Z - 1.0) ** 2).sum(-1), -(Z - 1.0)

    res = sample(None, {"x": torch.zeros(2)}, value_and_grad_fn=vag, num_samples=2,
                 num_warmup=2, num_chains=3, kernel="mala", seed=4, init_strategy="advi", **CPU)
    assert res.samples["x"].shape == (3, 2, 2)
    assert shapes[:501] == [(8, 2)] * 500 + [(3, 2)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fit_advi(lambda p: -(p["x"] ** 2).sum(), {"x": torch.zeros(2)}, num_steps=2)


def test_fit_through_a_fused_vag_equals_autograd():
    # The same model through its autograd value+grad and through a
    # closed-form one: the same draws, the same Adam steps; q within
    # float32 rounding of the two gradients (rtol 1e-5, atol 1e-6).
    loc, scale = torch.tensor([1.5, -2.0, 0.3]), torch.tensor([0.5, 3.0, 1.0])

    def flat_lp(z):
        return Normal(loc, scale).log_prob(z).sum()

    def vag(Z):
        return Normal(loc, scale).log_prob(Z).sum(-1), -(Z - loc) / scale**2

    z0 = torch.zeros(3)
    for fit in (vi.fit_advi_flat, vi.fit_advi_fullrank_flat):
        auto = fit(flat_lp, z0, 2, num_steps=200)
        fused = fit(None, z0, 2, num_steps=200, value_and_grad_fn=vag)
        for a, b in zip(auto, fused):
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    starts, inv_mass = advi_initialize(flat_lp, z0.expand(4, 3).contiguous(), 2, num_steps=50)
    f_starts, f_inv_mass = advi_initialize(None, z0.expand(4, 3).contiguous(), 2, num_steps=50,
                                           value_and_grad_fn=vag)
    torch.testing.assert_close(f_starts, starts, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(f_inv_mass, inv_mass, rtol=1e-5, atol=1e-6)


def test_advi_run_builds_its_own_runner():
    from mlx_mcmc_tpu_torch.inference.api import _RUNNER_CACHE, clear_runner_cache

    def log_prob(params):
        return torch.sum(Normal(1.0, 0.5).log_prob(params["x"]))

    kw = dict(num_samples=5, num_warmup=5, num_chains=2, kernel="hmc", seed=3,
              init_strategy="advi", **CPU)
    clear_runner_cache()
    a = sample(log_prob, {"x": torch.zeros(2)}, **kw)
    b = sample(log_prob, {"x": torch.zeros(2)}, **kw)
    # the fit's metric is a per-call value: one runner serves both runs
    assert len(_RUNNER_CACHE) == 1
    np.testing.assert_array_equal(a.samples["x"].numpy(), b.samples["x"].numpy())
    # q's variances became the initial metric: HMC's first step used them
    given = sample(log_prob, {"x": torch.zeros(2)}, init_inv_mass_diag=torch.ones(2), **kw)
    assert len(_RUNNER_CACHE) == 1
    assert not np.array_equal(given.samples["x"].numpy(), a.samples["x"].numpy())
