"""Port parity of tempered SMC (``inference/smc.py``) against
``mlx_mcmc_tpu/inference/smc.py``, and the reference's oracles
(``tests/test_smc.py``) on the CPU.

``_systematic_resample`` from the reference's own uniform gives its
indices (but where a stratum ties a boundary of the cumulative weights
within float32 rounding); the next-beta bisection from the same ``delta_lp`` gives its
increment (the reference's closure, ``smc.py:150-172``, restated in jnp
here, since the reference builds it inside its runner) to float32
tolerance. Then the reference's tests at their settings.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.inference.smc import _systematic_resample as j_systematic_resample
from mlx_mcmc_tpu_torch import HalfNormal, Normal, sample_smc
from mlx_mcmc_tpu_torch.inference import smc

CPU = dict(device="cpu")
_LOG_2PI = float(np.log(2.0 * np.pi))


def test_systematic_resample_matches_reference():
    rng = np.random.default_rng(0)
    for n in (7, 512, 4096):
        lw = (3.0 * rng.standard_normal(n)).astype(np.float32)
        key = jax.random.PRNGKey(n)
        idx_j = j_systematic_resample(key, jnp.asarray(lw))
        u = jax.random.uniform(key)  # smc.py:63
        idx = smc._systematic_resample(torch.from_numpy(lw), torch.tensor(float(u)))
        idx, idx_j = idx.numpy(), np.asarray(idx_j)
        # The two cumulative sums round in other orders: a stratum within
        # float32 rounding of a boundary may fall on either side of it.
        cum = np.cumsum(np.asarray(jax.nn.softmax(jnp.asarray(lw))), dtype=np.float64)
        strata = (float(u) + np.arange(n)) / n
        tie = np.min(np.abs(cum[None, :] - strata[:, None]), axis=1) < 1e-6
        assert (idx == idx_j).mean() > 0.999
        assert ((idx == idx_j) | tie).all()
        assert (np.abs(idx - idx_j) <= 1).all()


def _j_next_beta(beta, delta_lp, ess_target, num_particles):
    """The reference's ``next_beta`` (smc.py:150-172), its code as written."""
    target = ess_target * num_particles

    def ess_of(delta):
        lw = delta * delta_lp
        lw = lw - jnp.max(lw)
        w = jnp.exp(lw)
        return jnp.square(jnp.sum(w)) / jnp.sum(jnp.square(w))

    def body(_, lohi):
        lo, hi = lohi
        mid = 0.5 * (lo + hi)
        ok = ess_of(mid) >= target
        return jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)

    lo, hi = jax.lax.fori_loop(0, 30, body, (jnp.float32(0.0), 1.0 - beta))
    full_ok = ess_of(1.0 - beta) >= target
    delta = jnp.where(full_ok, 1.0 - beta, lo)
    return jnp.maximum(delta, 1e-6)


@pytest.mark.parametrize("beta,scale", [(0.0, 30.0), (0.3, 5.0), (0.9, 0.1)])
def test_next_beta_matches_reference(beta, scale):
    rng = np.random.default_rng(1)
    delta_lp = (scale * rng.standard_normal(1024) - scale).astype(np.float32)
    want = jax.jit(_j_next_beta, static_argnums=(2, 3))(
        jnp.float32(beta), jnp.asarray(delta_lp), 0.5, 1024)
    got = smc._next_beta(torch.tensor(beta, dtype=torch.float32), torch.from_numpy(delta_lp),
                         0.5 * 1024)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_moments_and_unit_evidence():
    def log_prob(params):
        return torch.sum(Normal(2.0, 1.5).log_prob(params["x"]))

    res = sample_smc(log_prob, {"x": torch.zeros(2)}, num_particles=2048, seed=0, q0_scale=3.0,
                     **CPU)
    pts = res.particles["x"].numpy()
    np.testing.assert_allclose(pts.mean(axis=0), 2.0, atol=0.15)
    np.testing.assert_allclose(pts.std(axis=0), 1.5, rtol=0.15)
    assert abs(res.log_evidence) < 0.25
    assert 1 <= res.num_stages < 100
    assert res.final_accept_rate > 0.05
    # one read of the loop's condition per stage and the one that ends it
    assert res.host_syncs == res.num_stages + 1 and res.final_beta == 1.0


def test_evidence_of_unnormalized_target():
    s = 2.0

    def log_prob(params):
        return -0.5 * torch.sum(params["x"] ** 2) / s**2

    res = sample_smc(log_prob, {"x": 0.0}, num_particles=4096, seed=1, q0_scale=4.0, **CPU)
    true_log_z = 0.5 * (_LOG_2PI + 2 * np.log(s))
    assert abs(res.log_evidence - true_log_z) < 0.2


def test_deterministic_under_seed():
    def log_prob(params):
        return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))

    kw = dict(num_particles=512, seed=5, **CPU)
    r1 = sample_smc(log_prob, {"x": torch.zeros(2)}, **kw)
    r2 = sample_smc(log_prob, {"x": torch.zeros(2)}, **kw)
    assert torch.equal(r1.particles["x"], r2.particles["x"])
    assert r1.log_evidence == r2.log_evidence


def test_validation():
    def log_prob(params):
        return Normal(0.0, 1.0).log_prob(params["x"])

    with pytest.raises(ValueError):
        sample_smc(log_prob, {"x": 0.0}, ess_target=1.5, **CPU)


def _mixture(params):
    x = params["x"]
    la = np.log(0.3) + Normal(-4.0, 0.5).log_prob(x)
    lb = np.log(0.7) + Normal(4.0, 0.5).log_prob(x)
    return torch.logaddexp(la, lb)


def test_bimodal_mass_allocation():
    res = sample_smc(_mixture, {"x": 0.0}, num_particles=4096, seed=0, q0_scale=6.0, **CPU)
    pts = res.particles["x"].numpy()
    assert abs((pts > 0).mean() - 0.7) < 0.1
    assert abs(res.log_evidence) < 0.3


def test_max_stages_warns():
    with pytest.warns(RuntimeWarning, match="max_stages=2"):
        res = sample_smc(_mixture, {"x": 0.0}, num_particles=256, seed=0, q0_scale=6.0,
                         max_stages=2, **CPU)
    assert res.final_beta < 1.0 and res.num_stages == 2 and res.host_syncs == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        sample_smc(_mixture, {"x": 0.0}, num_particles=256, seed=0, q0_scale=6.0, **CPU)


def test_positive_support():
    rng = np.random.default_rng(2)
    y = torch.from_numpy(rng.normal(0.0, 2.0, size=100).astype(np.float32))

    def log_prob(params):
        lp = HalfNormal(5.0).log_prob(params["sigma"])
        return lp + torch.sum(Normal(0.0, params["sigma"]).log_prob(y))

    res = sample_smc(log_prob, {"sigma": 1.0}, num_particles=2048, seed=0,
                     transforms={"sigma": "log"}, **CPU)
    pts = res.particles["sigma"].numpy()
    assert (pts > 0).all()
    assert abs(pts.mean() - 2.0) < 0.25


def test_data_argument():
    y = torch.full((50,), 3.0)

    def log_prob(params, data):
        return torch.sum(Normal(params["mu"], 1.0).log_prob(data)) + Normal(
            0.0, 10.0).log_prob(params["mu"])

    res = sample_smc(log_prob, {"mu": 0.0}, num_particles=1024, seed=0, data=y, q0_scale=3.0,
                     **CPU)
    assert abs(float(res.particles["mu"].mean()) - 3.0) < 0.1


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_smc(_mixture, {"x": 0.0}, num_particles=16)
