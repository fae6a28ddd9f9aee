"""The port's WAIC / PSIS-LOO (``diagnostics/model_comparison.py``) against
``mlx_mcmc_tpu/diagnostics/model_comparison.py``, and the reference's
oracles (``tests/test_model_comparison.py``) on the CPU.

``waic``, ``psis_loo`` and ``compare`` on the same (C, S, N) array give the
reference's numbers to 1e-6 relative; ``pointwise_log_likelihood`` (one
``torch.func.vmap`` over the flattened draws) gives the reference's at the
same draws to float32 tolerance. The oracles run on the port's own NUTS
draws of the reference's model.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu import Normal as JNormal
from mlx_mcmc_tpu.diagnostics import compare as j_compare
from mlx_mcmc_tpu.diagnostics import pointwise_log_likelihood as j_pointwise
from mlx_mcmc_tpu.diagnostics import psis_loo as j_psis_loo
from mlx_mcmc_tpu.diagnostics import waic as j_waic
from mlx_mcmc_tpu_torch import HalfNormal, Normal, sample
from mlx_mcmc_tpu_torch.diagnostics import compare, pointwise_log_likelihood, psis_loo, waic

N_OBS = 80
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def fitted():
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(2.0, 1.0, size=N_OBS).astype(np.float32))

    def log_prob(params):
        lp = Normal(0.0, 10.0).log_prob(params["mu"])
        lp = lp + HalfNormal(5.0).log_prob(params["sigma"])
        return lp + torch.sum(Normal(params["mu"], params["sigma"]).log_prob(y))

    res = sample(log_prob, {"mu": 0.0, "sigma": 1.0}, num_samples=500, num_warmup=400,
                 num_chains=4, kernel="nuts", seed=0, max_tree_depth=6,
                 transforms={"sigma": "log"}, **CPU)

    def log_lik(params):
        return Normal(params["mu"], params["sigma"]).log_prob(y)

    ll = pointwise_log_likelihood(log_lik, res.samples, **CPU)
    return y, res, ll


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_pointwise_matches_reference(fitted):
    y, res, ll = fitted
    samples = {k: v.numpy() for k, v in res.samples.items()}
    want = j_pointwise(lambda p: JNormal(p["mu"], p["sigma"]).log_prob(jnp.asarray(y.numpy())),
                       {k: jnp.asarray(v) for k, v in samples.items()})
    np.testing.assert_allclose(ll, want, rtol=1e-6, atol=1e-6)
    # with data
    got = pointwise_log_likelihood(lambda p, d: Normal(p["mu"], p["sigma"]).log_prob(d),
                                   res.samples, data=y, **CPU)
    np.testing.assert_array_equal(got, ll)


def test_estimators_match_reference(fitted):
    _, _, ll = fitted
    rng = np.random.default_rng(1)
    shifted = ll - 0.5 * rng.random(ll.shape[-1]).astype(np.float32)
    for arr in (ll, ll.reshape(-1, N_OBS), shifted):
        w, jw = waic(arr), j_waic(arr)
        for k in ("elpd_waic", "p_waic", "waic", "se"):
            _close(w[k], jw[k])
        _close(w["pointwise"], jw["pointwise"])
        lo, jlo = psis_loo(arr), j_psis_loo(arr)
        for k in ("elpd_loo", "p_loo", "se"):
            _close(lo[k], jlo[k])
        _close(lo["pareto_k"], jlo["pareto_k"])
        _close(lo["pointwise"], jlo["pointwise"])
    for method in ("loo", "waic"):
        t, jt = compare({"a": ll, "b": shifted}, method), j_compare({"a": ll, "b": shifted}, method)
        assert list(t) == list(jt)
        for name in t:
            for k, v in t[name].items():
                _close(v, jt[name][k])


def test_shape(fitted):
    _, _, ll = fitted
    assert ll.shape == (4, 500, N_OBS)
    assert np.isfinite(ll).all()


def test_waic_loo_agree_when_well_specified(fitted):
    _, _, ll = fitted
    w = waic(ll)
    lo = psis_loo(ll)
    assert abs(w["elpd_waic"] - lo["elpd_loo"]) < 0.5 * w["se"] + 1.0
    assert w["waic"] == pytest.approx(-2 * w["elpd_waic"])


def test_effective_parameters_near_two(fitted):
    _, _, ll = fitted
    assert 1.0 < waic(ll)["p_waic"] < 4.0
    assert 1.0 < psis_loo(ll)["p_loo"] < 4.0


def test_pareto_k_healthy(fitted):
    _, _, ll = fitted
    ks = psis_loo(ll)["pareto_k"]
    assert ks.shape == (N_OBS,)
    assert (ks < 0.7).mean() > 0.95


def test_elpd_magnitude_sane(fitted):
    _, _, ll = fitted
    per_obs = waic(ll)["elpd_waic"] / N_OBS
    assert -2.0 < per_obs < -1.0


def test_ranks_true_model_first(fitted):
    y, res, ll_true = fitted

    def log_lik_bad(params):
        return Normal(params["mu"] - 3.0, params["sigma"]).log_prob(y)

    ll_bad = pointwise_log_likelihood(log_lik_bad, res.samples, **CPU)
    for method in ("loo", "waic"):
        table = compare({"true": ll_true, "shifted": ll_bad}, method=method)
        assert table["true"]["rank"] == 0
        assert table["shifted"]["rank"] == 1
        assert table["true"]["elpd_diff"] == 0.0
        assert table["shifted"]["elpd_diff"] > 3 * table["shifted"]["diff_se"]


def test_psis_needs_enough_draws():
    with pytest.raises(ValueError, match="more posterior draws"):
        psis_loo(np.zeros((5, 3)))


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pointwise_log_likelihood(lambda p: p["mu"][None], {"mu": torch.ones((1, 2))})
