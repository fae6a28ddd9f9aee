"""Port parity of the ensemble sampler (``inference/ensemble.py``) against
``mlx_mcmc_tpu/inference/ensemble.py``, and the reference's oracles
(``tests/test_ensemble.py``) on the CPU.

``_half_update`` from the reference's own partners and uniforms (drawn as
``ensemble.py:38-52`` draws them) must give its proposals' fate exactly and
the new walkers, log densities and accept probabilities to float32
tolerance. Then the reference's tests at their settings: moments, the
untuned correlated target, reproducibility, shapes and the result
surface, ``thin`` (a thinned run keeps every ``thin``-th draw of the
unthinned one), validation, the log transform, ``data`` and the facade.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.inference.ensemble import _half_update as j_half_update
from mlx_mcmc_tpu_torch import MCMC, HalfNormal, Normal, sample_ensemble
from mlx_mcmc_tpu_torch.inference.ensemble import _half_update

CPU = dict(device="cpu")


def _gauss_model(loc, scale):
    def log_prob(params):
        return torch.sum(Normal(loc, scale).log_prob(params["x"]))

    return log_prob


@pytest.mark.parametrize("a", [2.0, 3.5])
def test_half_update_matches_reference(a):
    n_half, dim = 48, 5
    rng = np.random.default_rng(0)
    scales = np.linspace(0.5, 2.0, dim).astype(np.float32)
    active = rng.standard_normal((n_half, dim)).astype(np.float32)
    other = rng.standard_normal((n_half, dim)).astype(np.float32)

    def j_lp(z):
        return -0.5 * jnp.sum((z / scales) ** 2, axis=-1)

    def t_lp(z):
        return -0.5 * torch.sum((z / torch.from_numpy(scales)) ** 2, dim=-1)

    key = jax.random.PRNGKey(4)
    active_lp = j_lp(jnp.asarray(active))
    new_j, lp_j, acc_j, ap_j = j_half_update(key, jnp.asarray(active), active_lp,
                                             jnp.asarray(other), a, j_lp)
    # the reference's draws (ensemble.py:38-52)
    k_part, k_z, k_acc = jax.random.split(key, 3)
    partners = jax.random.randint(k_part, (n_half,), 0, n_half)
    u_z = jax.random.uniform(k_z, (n_half,))
    u_acc = jax.random.uniform(k_acc, (n_half,))
    new, lp, acc, ap = _half_update(
        torch.from_numpy(active), torch.from_numpy(np.array(active_lp)), torch.from_numpy(other),
        a, t_lp, torch.from_numpy(np.array(partners)).long(), torch.from_numpy(np.array(u_z)),
        torch.from_numpy(np.array(u_acc)))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(acc_j))
    assert 0 < int(acc.sum()) < n_half
    np.testing.assert_allclose(new.numpy(), np.asarray(new_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ap.numpy(), np.asarray(ap_j), rtol=1e-5, atol=1e-6)


def test_recovers_gaussian_moments():
    res = sample_ensemble(_gauss_model(2.0, 1.5), {"x": torch.zeros(3)}, num_walkers=64,
                          num_samples=800, num_warmup=500, seed=0, **CPU)
    draws = res.samples["x"].reshape(-1, 3).numpy()
    np.testing.assert_allclose(draws.mean(axis=0), 2.0, atol=0.15)
    np.testing.assert_allclose(draws.std(axis=0), 1.5, rtol=0.12)


def test_correlated_target_untuned():
    cov = np.array([[1.0, 0.97], [0.97, 1.0]])
    prec = torch.from_numpy(np.linalg.inv(cov).astype(np.float32))

    def log_prob(params):
        x = params["x"]
        return -0.5 * x @ prec @ x

    res = sample_ensemble(log_prob, {"x": torch.zeros(2)}, num_walkers=64, num_samples=1500,
                          num_warmup=800, seed=1, **CPU)
    draws = res.samples["x"].reshape(-1, 2).numpy()
    assert 0.2 < res.acceptance_rate < 0.8
    np.testing.assert_allclose(draws.std(axis=0), 1.0, rtol=0.15)
    assert np.corrcoef(draws.T)[0, 1] > 0.9


def test_reproducible_under_fixed_seed():
    kw = dict(num_walkers=16, num_samples=50, num_warmup=20, seed=7, **CPU)
    r1 = sample_ensemble(_gauss_model(0.0, 1.0), {"x": 0.0}, **kw)
    r2 = sample_ensemble(_gauss_model(0.0, 1.0), {"x": 0.0}, **kw)
    assert torch.equal(r1.samples["x"], r2.samples["x"])
    r3 = sample_ensemble(_gauss_model(0.0, 1.0), {"x": 0.0}, **dict(kw, seed=8))
    assert not torch.equal(r1.samples["x"], r3.samples["x"])


def test_shapes_and_result_surface():
    res = sample_ensemble(_gauss_model(0.0, 1.0), {"x": torch.zeros(2)}, num_walkers=32,
                          num_samples=40, num_warmup=10, seed=0, **CPU)
    assert res.samples["x"].shape == (32, 40, 2)
    assert res.info.accept_prob.shape == (32, 40)
    assert res.kernel == "ensemble" and float(res.tunables.step_size) == 2.0
    assert torch.equal(res.tunables.inv_mass_diag, torch.ones(2))
    assert {"x[0]", "x[1]"} == set(res.summary())
    d = res.diagnostics()
    assert "x" in d and d["x"]["n_eff"] > 0
    assert res.divergences == 0
    # info.log_prob is each walker's density at its stored position
    lp = torch.stack([_gauss_model(0.0, 1.0)({"x": z}) for z in res.samples["x"][:, -1]])
    np.testing.assert_allclose(res.info.log_prob[:, -1].numpy(), lp.numpy(), rtol=1e-6)


def test_thinning():
    res = sample_ensemble(_gauss_model(0.0, 1.0), {"x": 0.0}, num_walkers=16, num_samples=30,
                          num_warmup=10, thin=3, seed=0, **CPU)
    assert res.samples["x"].shape == (16, 30)
    # a thinned draw is the last step of its block: the unthinned run's
    full = sample_ensemble(_gauss_model(0.0, 1.0), {"x": 0.0}, num_walkers=16, num_samples=90,
                           num_warmup=10, seed=0, **CPU)
    assert torch.equal(res.samples["x"], full.samples["x"][:, 2::3])


def test_validation():
    with pytest.raises(ValueError):
        sample_ensemble(_gauss_model(0, 1), {"x": 0.0}, num_walkers=5, **CPU)
    with pytest.raises(ValueError):
        sample_ensemble(_gauss_model(0, 1), {"x": 0.0}, a=0.9, **CPU)


def test_positive_support_with_log_transform():
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.normal(0.0, 2.0, size=300).astype(np.float32))

    def log_prob(params):
        lp = HalfNormal(5.0).log_prob(params["sigma"])
        return lp + torch.sum(Normal(0.0, params["sigma"]).log_prob(data))

    res = sample_ensemble(log_prob, {"sigma": 1.0}, num_walkers=32, num_samples=800,
                          num_warmup=500, seed=0, transforms={"sigma": "log"}, **CPU)
    draws = res.samples["sigma"].numpy().ravel()
    assert (draws > 0).all()
    assert abs(draws.mean() - 2.0) < 0.25


def test_data_argument():
    y = torch.full((40,), 3.0)

    def log_prob(params, data):
        return torch.sum(Normal(params["mu"], 1.0).log_prob(data))

    res = sample_ensemble(log_prob, {"mu": 0.0}, num_walkers=16, num_samples=300,
                          num_warmup=200, seed=0, data=y, **CPU)
    assert abs(float(res.samples["mu"].mean()) - 3.0) < 0.1


def test_mcmc_facade_method_ensemble():
    mcmc = MCMC(_gauss_model(1.0, 2.0))
    samples = mcmc.run({"x": 0.0}, num_samples=400, num_warmup=300, method="ensemble",
                       num_chains=32, verbose=False, **CPU)
    draws = samples["x"]
    assert draws.shape == (32 * 400,)
    assert abs(draws.mean() - 1.0) < 0.25
    assert abs(draws.std() - 2.0) < 0.35
    s = mcmc.summary()
    assert {"mean", "std", "median", "2.5%", "97.5%"} <= set(s["x"])
    # num_chains=1 means the sampler's 64 walkers, jitter 0 means 0.1
    mcmc.run({"x": 0.0}, num_samples=5, num_warmup=5, method="ensemble", verbose=False, **CPU)
    assert mcmc.result.num_chains == 64
    alone = sample_ensemble(_gauss_model(1.0, 2.0), {"x": 0.0}, num_walkers=64, num_samples=5,
                            num_warmup=5, jitter=0.1, **CPU)
    assert torch.equal(torch.from_numpy(mcmc.samples["x"]), alone.samples["x"].reshape(-1))


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_ensemble(_gauss_model(0, 1), {"x": 0.0}, num_samples=2, num_warmup=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MCMC(_gauss_model(0, 1)).run({"x": 0.0}, num_samples=2, num_warmup=2,
                                     method="ensemble", verbose=False)
