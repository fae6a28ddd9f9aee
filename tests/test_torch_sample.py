"""The whole slice: ``sample()`` of both packages on one small logistic GLM.

The data come from numpy and reach both packages as the same arrays (the
port's through ``convert.py``); the random streams differ (threefry vs
Philox), so the runs agree statistically: posterior means within 5 Monte
Carlo standard errors, posterior sds within 10%, mean accept within 0.05
and mean tree depth within 0.5. A short centered eight-schools run of the
port must complete with finite draws.
"""

import jax.numpy as jnp
import numpy as np
import torch

from mlx_mcmc_tpu import sample as j_sample
from mlx_mcmc_tpu.ops.pallas.glm import make_fused_logistic_vag as j_make_vag
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.convert import fused_logistic_data_from_jax, params_from_jax
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size
from mlx_mcmc_tpu_torch.models import eight_schools
from mlx_mcmc_tpu_torch.ops.glm import make_fused_logistic_vag

RUN = dict(num_chains=64, num_warmup=200, num_samples=300, max_tree_depth=6, target_accept=0.8)


def _moments(draws):
    draws = np.asarray(draws, np.float64)  # (chains, draws, D)
    flat = draws.reshape(-1, draws.shape[-1])
    sd = flat.std(0)
    return flat.mean(0), sd, sd / np.sqrt(effective_sample_size(draws))


def test_sample_matches_reference_statistically():
    rng = np.random.default_rng(0)
    n, d = 500, 5
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=128)

    def j_log_prob(params, data):
        s = data["Xp"][:, :d] @ params["beta"]
        ll = jnp.sum(data["yp"][:, 0] * s - jnp.logaddexp(s, 0.0)) + data["pad_const"]
        return ll - 0.5 * jnp.sum(params["beta"] ** 2) - 0.5 * d * np.log(2 * np.pi)

    jres = j_sample(
        j_log_prob, {"beta": jnp.zeros(d)}, data=jdata, seed=0,
        value_and_grad_fn=j_make_vag(prior_scale=1.0, data_aware=True, use_pallas=False),
        **RUN,
    )
    tdata = fused_logistic_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    tres = sample(
        None, params_from_jax({"beta": jnp.zeros(d)}, device="cpu"), data=tdata, seed=0,
        value_and_grad_fn=make_fused_logistic_vag(prior_scale=1.0), device="cpu", **RUN,
    )
    assert tres.samples["beta"].shape == (64, 300, d)
    mean_j, sd_j, mcse_j = _moments(jres.samples["beta"])
    mean_t, sd_t, mcse_t = _moments(tres.samples["beta"])
    assert np.all(np.abs(mean_t - mean_j) <= 5 * np.hypot(mcse_t, mcse_j))
    assert np.all(np.abs(sd_t / sd_j - 1) <= 0.10)
    assert abs(tres.acceptance_rate - jres.acceptance_rate) <= 0.05
    depth_j = float(np.mean(np.asarray(jres.info.tree_depth)))
    depth_t = float(tres.info.tree_depth.float().mean())
    assert abs(depth_t - depth_j) <= 0.5
    assert tres.divergences == 0
    assert tres.host_syncs > RUN["num_warmup"] + RUN["num_samples"]
    diag = tres.diagnostics()["beta"]
    assert diag["r_hat"] < 1.05 and diag["n_eff"] > 1000
    summary = tres.summary()
    assert set(summary) == {f"beta[{i}]" for i in range(d)}
    assert abs(summary["beta[0]"]["mean"] - mean_t[0]) < 1e-6


def test_centered_eight_schools_completes():
    spec = eight_schools(centered=True, device="cpu")
    res = sample(
        spec.log_prob, spec.initial_params, num_chains=32, num_warmup=40,
        num_samples=30, max_tree_depth=5, target_accept=0.9, seed=3, device="cpu",
    )
    assert res.samples["theta"].shape == (32, 30, 8)
    assert res.samples["mu"].shape == (32, 30)
    for v in res.samples.values():
        assert torch.isfinite(v).all()
    assert 0.0 < res.acceptance_rate <= 1.0
