"""Port parity: the fused logistic value+grad.

- The plain PyTorch version against the reference's Pallas kernel body in
  interpret mode on bf16 X, at ragged N, D and C. Both round Z and the
  residual to bf16 and accumulate in float32; only summation order differs.
  Tolerances: ll 1e-3 nats + 1e-5 relative; g 1e-4 of max|g| + 1e-5, tighter
  than the ~6e-4 of max|g| that skipping the residual rounding moves g.
- The full vag with its prior against the reference's non-Pallas vag on
  float32 X, through ``convert.py`` (1e-4 relative: the reference uses
  log1p(exp(-|s|)) where the kernel uses the tanh form).
- The CUDA kernel against the plain version: ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import fused_logistic_value_and_grad as j_fused
from mlx_mcmc_tpu.ops.pallas.glm import make_fused_logistic_vag as j_make_vag
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu_torch.convert import fused_logistic_data_from_jax
from mlx_mcmc_tpu_torch.ops import glm


def _problem(n, d, c, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
    Z = (beta + rng.standard_normal((c, d))).astype(np.float32)
    return X, y, Z


@pytest.mark.parametrize("n,d,c", [(300, 10, 16), (257, 37, 33)])
def test_plain_version_matches_pallas_interpret_bf16(n, d, c):
    X, y, Z = _problem(n, d, c)
    Xb = X.astype(ml_dtypes.bfloat16)
    ll_j, g_j = j_fused(jnp.asarray(Xb), jnp.asarray(y), jnp.asarray(Z), tile_n=128, interpret=True)
    data = glm.prepare_fused_logistic_data(
        torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu"
    )
    assert data["Xp"].dtype == torch.bfloat16 and data["Xp"].shape[1] % 16 == 0
    ll_t, g_t = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], torch.from_numpy(Z))
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5, atol=1e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-5
    # The residual rounding matters at this tolerance: without it g moves.
    Xf = data["Xp"][:, :d].float()
    s = torch.from_numpy(Z).bfloat16().float() @ Xf.T
    g_unrounded = (data["yp"] - torch.sigmoid(s)) @ Xf
    assert np.abs(g_unrounded.numpy() - g_j).max() > 1e-4 * np.abs(g_j).max()


def test_vag_with_prior_matches_reference_f32_through_convert():
    n, d, c = 300, 7, 12
    X, y, Z = _problem(n, d, c, seed=1)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=128)
    jvag = j_make_vag(prior_scale=2.0, data_aware=True, use_pallas=False)
    import jax

    ll_j, g_j = jax.vmap(lambda z: jvag(z, jdata))(jnp.asarray(Z))
    tdata = fused_logistic_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    assert tdata["Xp"].dtype == torch.float32 and tdata["dim"] == d
    assert tdata["Xp"].shape[0] == 384 and tdata["pad_const"] > 0  # padded rows + constant
    ll_t, g_t = glm.make_fused_logistic_vag(prior_scale=2.0)(torch.from_numpy(Z), tdata)
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-4)
    # Unpadded port data gives the same value (the kernel masks, pad_const 0).
    own = glm.prepare_fused_logistic_data(torch.from_numpy(X), torch.from_numpy(y), device="cpu")
    assert own["pad_const"] == 0.0 and own["Xp"].shape == (n, 16)
    ll_o, g_o = glm.make_fused_logistic_vag(prior_scale=2.0)(torch.from_numpy(Z), own)
    np.testing.assert_allclose(ll_o.numpy(), ll_t.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_o.numpy(), g_t.numpy(), rtol=1e-5, atol=1e-5)


def test_model_log_prob_agrees_with_fused_vag():
    # The GLM model's per-chain log_prob (autograd) and the fused vag on the
    # same bf16 data: ll to 1e-4 relative (softplus forms differ), g to
    # 1e-2 of max|g| (the fused path rounds the residual to bf16).
    from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
    from mlx_mcmc_tpu_torch.models import make_logistic_regression
    from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

    spec = make_logistic_regression(6, 400, seed=3, data_dtype=torch.bfloat16, device="cpu")
    assert spec.X.dtype == torch.bfloat16 and set(spec.y.unique().tolist()) <= {0.0, 1.0}
    flp, z0, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device="cpu")
    Z = spec.true_beta + 0.2 * torch.randn(9, 6, generator=torch.Generator().manual_seed(0))
    Z = Z.bfloat16().float()  # both paths round Z to bf16 for the product only
    ll_m, g_m = make_batched_value_and_grad(flp)(Z)
    data = glm.prepare_fused_logistic_data(spec.X, spec.y, device="cpu")
    ll_f, g_f = glm.make_fused_logistic_vag()(Z, data)
    np.testing.assert_allclose(ll_f.numpy(), ll_m.numpy(), rtol=1e-4)
    assert float((g_f - g_m).abs().max()) <= 1e-2 * float(g_m.abs().max())


def test_bf16_data_converts_from_jax():
    X, y, _ = _problem(50, 4, 1)
    jdata = j_prepare(jnp.asarray(X).astype(jnp.bfloat16), jnp.asarray(y), tile_n=64)
    tdata = fused_logistic_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    assert tdata["Xp"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tdata["Xp"].float().numpy(), np.asarray(jdata["Xp"]).astype(np.float32)
    )


def test_cpu_tensors_take_the_plain_version_and_kernel_refuses_them():
    X, y, Z = _problem(40, 3, 5)
    data = glm.prepare_fused_logistic_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu")
    before = glm.fused_logistic_vag_cuda.launches
    glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], torch.from_numpy(Z))
    assert glm.fused_logistic_vag_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], torch.from_numpy(Z))
    # int8 X is taken: the same int8 values and scales as the reference's.
    q = glm.prepare_fused_logistic_data(X, y, quantize="int8", device="cpu")
    jq = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=64, quantize="int8")
    np.testing.assert_array_equal(q["Xp"][:, :3].numpy(), np.asarray(jq["Xp"])[:40, :3])
    np.testing.assert_array_equal(q["col_scale"].numpy(), np.asarray(jq["col_scale"]))
    # num_shards pads the rows to a multiple of the shard count, as the
    # reference pads them to tile_n x num_shards (here 40 rows need none)
    sharded = glm.prepare_fused_logistic_data(X, y, num_shards=3, device="cpu")
    assert sharded["Xp"].shape[0] == 42 and not sharded["Xp"][40:].any()
    assert sharded["pad_const"] == pytest.approx(2 * np.log(2.0) / 3)
