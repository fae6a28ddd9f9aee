"""The port's ``MCMC`` facade against ``tests/test_facade.py`` (minus the
sharded and MAP-init cases, not ported), and against the JAX facade.

The README quick start's model (``Normal(0, 10)`` and ``HalfNormal(5)``
priors, a normal likelihood over 100 observations from a numpy seed) runs
through both facades with NUTS: posterior means within 4 combined Monte
Carlo standard errors (sd / sqrt(ESS), each package's ESS of its own
draws) and posterior sds within 15%. The summary keys of both facades on
the same model are the same, key for key.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_mcmc_tpu as j
from mlx_mcmc_tpu_torch import MCMC, HalfNormal, Normal, sample
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size

Y = np.random.default_rng(42).normal(5.0, 2.0, 100).astype(np.float32)
DATA = torch.from_numpy(Y)


def log_prob(params):
    mu, sigma = params["mu"], params["sigma"]
    return (Normal(0, 10).log_prob(mu) + HalfNormal(5).log_prob(sigma)
            + torch.sum(Normal(mu, sigma).log_prob(DATA)))


def j_log_prob(params):
    mu, sigma = params["mu"], params["sigma"]
    return (j.Normal(0, 10).log_prob(mu) + j.HalfNormal(5).log_prob(sigma)
            + jnp.sum(j.Normal(mu, sigma).log_prob(jnp.asarray(Y))))


INIT = {"mu": 0.0, "sigma": 1.0}
CPU = dict(verbose=False, device="cpu")


def test_run_returns_flat_numpy_dict_and_stats():
    mcmc = MCMC(log_prob)
    samples = mcmc.run(INIT, num_samples=200, num_warmup=200, method="nuts", num_chains=2,
                       **CPU)
    assert isinstance(samples["mu"], np.ndarray) and samples["mu"].shape == (400,)
    assert mcmc.result.samples["mu"].shape == (2, 200)
    assert abs(samples["mu"].mean() - Y.mean()) < 0.4
    assert mcmc.acceptance_rate == mcmc.result.acceptance_rate
    assert mcmc.stats.tree_depth.shape == (2, 200) and float(mcmc.stats.accept_prob.min()) >= 0
    diag = mcmc.diagnostics()
    assert diag["mu"]["r_hat"] < 1.05 and diag["mu"]["n_eff"] > 100


def test_metropolis_warmup_restarts_at_seed_plus_one():
    """The warmup run, then every chain restarted from its last warmup
    draw with seed + 1 (reference mcmc.py:145-178): the facade's draws
    equal those two ``sample()`` calls."""
    mcmc = MCMC(log_prob)
    samples = mcmc.run(INIT, num_samples=300, num_warmup=300, method="metropolis",
                       proposal_scale=0.3, random_seed=4, num_chains=3, **CPU)
    fixed = dict(num_warmup=0, num_chains=3, kernel="metropolis", step_size=0.3,
                 adapt_step_size=False, adapt_mass_matrix=False, device="cpu")
    warm = sample(log_prob, INIT, num_samples=300, seed=4, **fixed)
    start = {k: v[:, -1] for k, v in warm.samples.items()}
    rest = sample(log_prob, start, num_samples=300, seed=5, batched_initial=True, **fixed)
    assert samples["mu"].shape == (900,)
    np.testing.assert_array_equal(samples["mu"], rest.samples["mu"].numpy().ravel())
    # after warmup the chains start near the mode, not at 0
    assert abs(mcmc.result.samples["mu"][:, :50].mean().item() - Y.mean()) < 1.0
    assert not mcmc.stats.is_divergent.any()


def test_summary_keys_match_the_jax_facade():
    mcmc = MCMC(log_prob)
    mcmc.run(INIT, num_samples=100, num_warmup=100, method="hmc", num_leapfrog_steps=5, **CPU)
    jm = j.MCMC(j_log_prob)
    jm.run(INIT, num_samples=100, num_warmup=100, method="hmc", num_leapfrog_steps=5,
           verbose=False)
    s, js = mcmc.summary(), jm.summary()
    assert list(s) == list(js) == ["mu", "sigma"]
    assert list(s["mu"]) == list(js["mu"])
    assert list(s["mu"])[:5] == ["mean", "std", "median", "2.5%", "97.5%"]
    assert list(mcmc.summary(credible_interval=0.9)["mu"]) == list(
        jm.summary(credible_interval=0.9)["mu"])
    assert list(mcmc.diagnostics()["mu"]) == list(jm.diagnostics()["mu"])


def test_print_summary_and_verbose(capsys):
    mcmc = MCMC(log_prob)
    mcmc.run(INIT, num_samples=50, num_warmup=50, method="hmc", num_leapfrog_steps=3, **CPU)
    assert capsys.readouterr().out == ""
    mcmc.print_summary()
    out = capsys.readouterr().out
    assert "Posterior Summary" in out and "mu" in out and "sigma" in out
    mcmc.run(INIT, num_samples=20, num_warmup=20, method="metropolis", device="cpu")
    out = capsys.readouterr().out
    assert "METROPOLIS sampling" in out and "Warmup acceptance rate" in out


def test_errors():
    with pytest.raises(ValueError, match="Unknown sampling method"):
        MCMC(log_prob).run({"mu": 0.0}, method="gibbs")
    with pytest.raises(ValueError, match="Must run sampling first"):
        MCMC(log_prob).summary()
    with pytest.raises(ValueError, match="chain_method"):
        MCMC(log_prob).run({"mu": 0.0}, chain_method="pmap", verbose=False)
    with pytest.raises(NotImplementedError, match="A.9"):
        MCMC(log_prob).run(INIT, method="ensemble", **CPU)
    with pytest.raises(NotImplementedError, match="A.10"):
        MCMC(log_prob).run(INIT, method="nuts", chain_method="sharded", **CPU)


def test_progress_callback_fires_at_reporting_steps():
    events = []

    def cb(phase, t, accept, eps):
        events.append((phase, t, accept, eps))

    kw = dict(num_samples=50, num_warmup=50, num_chains=2, kernel="hmc", seed=0,
              num_leapfrog_steps=3, step_size=0.2, device="cpu")
    quiet = sample(log_prob, INIT, **kw)
    res = sample(log_prob, INIT, progress_every=10, progress_callback=cb, **kw)
    assert [(p, t) for p, t, _, _ in events] == (
        [("warmup", t) for t in range(9, 50, 10)] + [("sample", t) for t in range(59, 100, 10)])
    assert all(isinstance(a, float) and isinstance(e, float) for _, _, a, e in events)
    assert res.host_syncs == quiet.host_syncs + 10  # one read per report
    assert torch.equal(res.samples["mu"], quiet.samples["mu"])


def _moments(draws):
    draws = np.asarray(draws, np.float64)
    sd = draws.std()
    return draws.mean(), sd, sd / math.sqrt(float(effective_sample_size(draws)))


def test_readme_model_agrees_with_the_jax_facade():
    kw = dict(num_samples=300, num_warmup=200, method="nuts", num_chains=4, verbose=False)
    mcmc = MCMC(log_prob)
    mcmc.run(INIT, device="cpu", **kw)
    jm = j.MCMC(j_log_prob)
    jm.run(INIT, **kw)
    for k in ("mu", "sigma"):
        m_t, sd_t, se_t = _moments(mcmc.result.samples[k].numpy())
        m_j, sd_j, se_j = _moments(np.asarray(jm.result.samples[k]))
        assert abs(m_t - m_j) <= 4 * math.hypot(se_t, se_j), k
        assert abs(sd_t / sd_j - 1) <= 0.15, k
