"""Port parity: the fused GLM value+grad on f32 X (K1 logistic, K2 linear,
K4 hoisted).

The reference's kernels take f32 X (``x_ref`` is "f32, bf16, or int8",
mlx_mcmc_tpu/ops/pallas/glm.py:87) and round nothing then: ``Bt`` is Z in
f32 and the residual is cast to X's type. The port's plain versions on f32
X against the reference's Pallas kernel bodies in interpret mode, at ragged
shapes including D > 128: ll within the reference's own f32 tolerance
(rtol 2e-5, tests/test_pallas.py), g within rtol 2e-4 and atol 2e-5 of the
same test. Both sides accumulate in float32; only summation order differs.
The CUDA kernels against the plain versions: ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import _fused_hoisted_kernel, _fused_padded_call
from mlx_mcmc_tpu.ops.pallas.glm import fused_linear_value_and_grad as j_linear
from mlx_mcmc_tpu.ops.pallas.glm import fused_logistic_value_and_grad as j_logistic
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu_torch.ops import glm

_TILE = 128


def _problem(n, d, c, family, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    if family == "linear":
        y = (X @ beta + rng.standard_normal(n)).astype(np.float32)
        Z = (beta + 0.3 * rng.standard_normal((c, d))).astype(np.float32)
    else:
        y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
        Z = (beta + rng.standard_normal((c, d))).astype(np.float32)
    return X, y, Z


def _reference(family, X, y, Z):
    """The reference's Pallas kernel in interpret mode on f32 X."""
    if family == "logistic":
        return j_logistic(jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z), tile_n=_TILE, interpret=True)
    if family == "linear":
        return j_linear(jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z), tile_n=_TILE, interpret=True)
    n, d = X.shape
    c = Z.shape[0]
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=_TILE)
    Xp = jdata["Xp"]
    assert Xp.dtype == jnp.float32
    Bt = jnp.zeros((Xp.shape[1], 128), jnp.float32).at[:d, :c].set(jnp.asarray(Z).T)
    sp_pad, gs_pad = _fused_padded_call(Xp, jdata["yp"], Bt, _TILE, True, kernel_fn=_fused_hoisted_kernel)
    # The reference's padded rows each add softplus(0) = log 2; take them out.
    return np.asarray(sp_pad)[0, :c] - (Xp.shape[0] - n) * np.log(2.0), np.asarray(gs_pad)[:d, :c].T


@pytest.mark.parametrize("family", ["logistic", "linear", "hoisted"])
@pytest.mark.parametrize("n,d,c", [(300, 17, 5), (257, 37, 33), (260, 300, 9)])
def test_plain_version_matches_pallas_interpret_f32(n, d, c, family):
    X, y, Z = _problem(n, d, c, family)
    ll_j, g_j = (np.asarray(a) for a in _reference(family, X, y, Z))
    prep = glm.prepare_fused_linear_data if family == "linear" else glm.prepare_fused_logistic_data
    data = prep(torch.from_numpy(X), torch.from_numpy(y), device="cpu")
    assert data["Xp"].dtype == torch.float32 and data["Xp"].shape == (n, -(-d // 16) * 16)
    plan = glm.launch_plan(n, data["Xp"].shape[1], c, 132, data["Xp"].dtype)
    assert plan["path"] == "f32" and plan["rt_dtype"] == torch.float32  # no rounding on the card
    Zt = torch.from_numpy(Z)
    if family == "logistic":
        ll_t, g_t = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], Zt)
    elif family == "linear":
        ll_t, g_t = glm.fused_linear_value_and_grad(data["Xp"], data["yp"], Zt)
    else:
        ll_t, g_t = glm.fused_hoisted_value_and_grad(data["Xp"], Zt)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=2e-4, atol=2e-5)


def test_f32_plain_version_rounds_nothing():
    # Rounding Z or the residual to bf16 would move ll and g far beyond the
    # f32 tolerance above: the f32 path must keep both in f32.
    X, y, Z = _problem(257, 37, 8, "logistic", seed=1)
    data = glm.prepare_fused_logistic_data(torch.from_numpy(X), torch.from_numpy(y), device="cpu")
    ll_t, g_t = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], torch.from_numpy(Z))
    Xd, yd, Zd = (torch.from_numpy(a).double() for a in (X, y, Z))
    s = Zd @ Xd.T
    ll_d = (yd * s - torch.nn.functional.softplus(s)).sum(-1)
    g_d = (yd - torch.sigmoid(s)) @ Xd
    np.testing.assert_allclose(ll_t.numpy(), ll_d.numpy(), rtol=2e-6)
    np.testing.assert_allclose(g_t.numpy(), g_d.numpy(), rtol=1e-5, atol=1e-5)
    s_b = torch.from_numpy(Z).bfloat16().double() @ Xd.T
    ll_b = (yd * s_b - torch.nn.functional.softplus(s_b)).sum(-1)
    assert float((ll_b - ll_d).abs().max()) > 20 * float((ll_t.double() - ll_d).abs().max())
