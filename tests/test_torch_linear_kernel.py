"""Port parity: the fused Gaussian linear-regression value+grad (K2).

- The plain PyTorch version against the reference's Pallas kernel body in
  interpret mode on bf16 X, at ragged N, D and C, with K1's tolerances
  (ll 1e-3 nats + 1e-5 relative; g 1e-4 of max|g| + 1e-5): both round Z
  and the residual to bf16 and accumulate in float32.
- The full vag (noise scale, normalizer, prior) against the reference's
  non-Pallas vag on float32 X through ``convert.py``, at 1e-5 relative.
- The converter, the model's log density, and a small CPU ``sample()``
  against the exact Gaussian posterior.
The CUDA kernel against the plain version: ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import fused_linear_value_and_grad as j_fused
from mlx_mcmc_tpu.ops.pallas.glm import make_fused_linear_vag as j_make_vag
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_linear_data as j_prepare
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.convert import fused_linear_data_from_jax
from mlx_mcmc_tpu_torch.ops import glm


def _problem(n, d, c, seed=0, noise=1.0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (X @ beta + noise * rng.standard_normal(n)).astype(np.float32)
    Z = (beta + 0.3 * rng.standard_normal((c, d))).astype(np.float32)
    return X, y, Z


@pytest.mark.parametrize("n,d,c", [(300, 10, 16), (257, 37, 33)])
def test_plain_version_matches_pallas_interpret_bf16(n, d, c):
    X, y, Z = _problem(n, d, c)
    Xb = X.astype(ml_dtypes.bfloat16)
    ll_j, g_j = j_fused(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(Z), tile_n=128, interpret=True)
    data = glm.prepare_fused_linear_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu")
    assert data["Xp"].dtype == torch.bfloat16 and data["Xp"].shape == (n, -(-d // 16) * 16)
    ll_t, g_t = glm.fused_linear_value_and_grad(data["Xp"], data["yp"], torch.from_numpy(Z))
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5, atol=1e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-5
    # Both rounding points matter at this tolerance.
    Xf = data["Xp"][:, :d].float()
    s = torch.from_numpy(Z).bfloat16().float() @ Xf.T
    g_unrounded = (data["yp"] - s) @ Xf
    assert np.abs(g_unrounded.numpy() - g_j).max() > 1e-4 * np.abs(g_j).max()


@pytest.mark.parametrize("noise,prior,include_prior", [(1.0, 1.0, True), (0.7, 2.0, True), (0.7, 2.0, False)])
def test_vag_matches_reference_f32_through_convert(noise, prior, include_prior):
    n, d, c = 300, 7, 12
    X, y, Z = _problem(n, d, c, seed=1, noise=noise)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), noise_scale=noise, tile_n=128)
    jvag = j_make_vag(prior_scale=prior, use_pallas=False, include_prior=include_prior)
    ll_j, g_j = jax.vmap(lambda z: jvag(z, jdata))(jnp.asarray(Z))
    tdata = fused_linear_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    assert tdata["Xp"].shape == (384, 128) and tdata["dim"] == d  # the reference's padding
    tvag = glm.make_fused_linear_vag(prior_scale=prior, include_prior=include_prior)
    ll_t, g_t = tvag(torch.from_numpy(Z), tdata)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-5)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-4)
    # The port's own unpadded data give the same values.
    own = glm.prepare_fused_linear_data(torch.from_numpy(X), torch.from_numpy(y), noise_scale=noise, device="cpu")
    assert own["Xp"].shape == (n, 16) and own["ll_norm"] == pytest.approx(tdata["ll_norm"], rel=1e-6)
    ll_o, g_o = tvag(torch.from_numpy(Z), own)
    np.testing.assert_allclose(ll_o.numpy(), ll_t.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_o.numpy(), g_t.numpy(), rtol=1e-5, atol=1e-5)


def test_bf16_data_convert_from_jax():
    X, y, _ = _problem(50, 4, 1)
    jdata = j_prepare(jnp.asarray(X).astype(jnp.bfloat16), jnp.asarray(y), noise_scale=0.5, tile_n=64)
    tdata = fused_linear_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    assert tdata["Xp"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tdata["Xp"].float().numpy(), np.asarray(jdata["Xp"]).astype(np.float32))
    np.testing.assert_array_equal(tdata["yp"].numpy(), np.asarray(jdata["yp"])[:, 0])
    assert tdata["inv_noise_var"] == 4.0 and tdata["dim"] == 4


def test_model_log_prob_agrees_with_fused_vag():
    from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
    from mlx_mcmc_tpu_torch.models import make_linear_regression
    from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

    spec = make_linear_regression(6, 400, noise_scale=0.5, seed=3, data_dtype=torch.bfloat16, device="cpu")
    assert spec.X.dtype == torch.bfloat16 and spec.y.dtype == torch.float32
    flp, _, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device="cpu")
    Z = spec.true_beta + 0.2 * torch.randn(9, 6, generator=torch.Generator().manual_seed(0))
    Z = Z.bfloat16().float()  # both paths round Z to bf16 for the product only
    ll_m, g_m = make_batched_value_and_grad(flp)(Z)
    data = glm.prepare_fused_linear_data(spec.X, spec.y, noise_scale=0.5, device="cpu")
    ll_f, g_f = glm.make_fused_linear_vag()(Z, data)
    # The model omits the normalizers: the two differ by one constant.
    diff = (ll_f - ll_m).double()
    assert float(diff.max() - diff.min()) < 1e-3 * float(ll_m.abs().max())
    assert float((g_f - g_m).abs().max()) <= 1e-2 * float(g_m.abs().max())


def test_cpu_tensors_take_the_plain_version_and_kernel_refuses_them():
    X, y, Z = _problem(40, 3, 5)
    data = glm.prepare_fused_linear_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu")
    before = glm.fused_linear_vag_cuda.launches
    glm.fused_linear_value_and_grad(data["Xp"], data["yp"], torch.from_numpy(Z))
    assert glm.fused_linear_vag_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        glm.fused_linear_vag_cuda(data["Xp"], data["yp"], torch.from_numpy(Z))
    with pytest.raises(ValueError, match="quantize"):  # as the reference: no int8
        glm.prepare_fused_linear_data(X, y, quantize="int8", device="cpu")
    # num_shards pads the rows to a multiple of the shard count and divides
    # the Gaussian normalizer of the unpadded rows (the reference's
    # glm.py:426-427)
    sharded = glm.prepare_fused_linear_data(X, y, num_shards=3, device="cpu")
    assert sharded["Xp"].shape[0] == 42 and not sharded["Xp"][40:].any()
    assert sharded["ll_norm"] == pytest.approx(data["ll_norm"] / 3)
    with pytest.raises(ValueError, match="columns"):
        glm.make_fused_linear_vag()(torch.zeros(2, 4), data)


def test_sample_matches_the_exact_posterior():
    from mlx_mcmc_tpu_torch.models import make_linear_regression

    spec = make_linear_regression(5, 200, noise_scale=1.0, seed=4, device="cpu")
    data = glm.prepare_fused_linear_data(spec.X, spec.y, device="cpu")
    res = sample(
        None, spec.initial_params, data=data, value_and_grad_fn=glm.make_fused_linear_vag(),
        num_chains=32, num_warmup=200, num_samples=300, max_tree_depth=6,
        target_accept=0.8, seed=2, device="cpu",
    )
    X, y = spec.X.double(), spec.y.double()
    cov = torch.linalg.inv(X.T @ X + torch.eye(5, dtype=torch.float64))
    mean, sd = cov @ (X.T @ y), cov.diagonal().sqrt()
    draws = res.samples["beta"].double().reshape(-1, 5)
    assert float(((draws.mean(0) - mean).abs() / sd).max()) < 0.1
    assert float((draws.std(0) / sd - 1).abs().max()) < 0.1
    assert abs(res.acceptance_rate - 0.8) < 0.05 and res.divergences == 0
