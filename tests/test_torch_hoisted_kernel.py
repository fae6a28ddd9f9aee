"""Port parity: the hoisted-outcome GLM kernel (K4), the reference's
rejected ``_fused_hoisted_kernel``.

- The plain PyTorch version against the reference's kernel body in Pallas
  interpret mode (``_fused_padded_call(..., kernel_fn=_fused_hoisted_kernel)``)
  on bf16 and int8 X, at a one-pass and a wide shape: ``sum softplus(s)``
  (the reference's padded rows each add log 2, taken out as its benchmark
  does) within 1e-3 nats + 1e-5 relative, ``X^T bf16(sigmoid(s))`` within
  1e-4 of its max + 1e-5; and the rebuilt likelihood ``ll = yX . bf16(z) -
  sp``, ``g = yX - gs`` (benchmarks/glm_kernel_variants.py:186, 216-220)
  against the same rebuild from the reference's outputs.
- The rebuild against K1 (``fused_logistic_value_and_grad``) on the same
  inputs: at N = 300 the two O(N) sums cancel to within 1e-3 nats.
- K4 is on no sampling path: no vag factory offers it.
The CUDA kernel against the plain version: ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import _fused_hoisted_kernel, _fused_padded_call
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu_torch.ops import glm

_TILE = 128


def _problem(n, d, c, seed=0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
    Z = (beta + rng.standard_normal((c, d))).astype(np.float32)
    return X, y, Z


def _reference_hoisted(X, y, Z, quantize):
    """The reference's K4 in interpret mode on its padded data: (sp, gs, yX,
    col_scale), with its padded rows' log 2 taken out of sp."""
    n, d = X.shape
    c = Z.shape[0]
    Xj = jnp.asarray(X) if quantize else jnp.asarray(X).astype(jnp.bfloat16)
    jdata = j_prepare(Xj, jnp.asarray(y), tile_n=_TILE, quantize=quantize)
    col_scale = np.asarray(jdata["col_scale"]) if quantize else np.ones(d, np.float32)
    Xp = jdata["Xp"]
    Bt = jnp.zeros((Xp.shape[1], 128), jnp.bfloat16).at[:d, :c].set(
        jnp.asarray(Z * col_scale).astype(jnp.bfloat16).T
    )
    sp_pad, gs_pad = _fused_padded_call(Xp, jdata["yp"], Bt, _TILE, True, kernel_fn=_fused_hoisted_kernel)
    pad_rows = Xp.shape[0] - n
    sp = np.asarray(sp_pad)[0, :c] - pad_rows * np.log(2.0)
    gs = np.asarray(gs_pad)[:d, :c].T
    Xf = np.asarray(Xp[:n, :d]).astype(np.float32)
    yX = Xf.T @ y
    bz = np.asarray(Bt[:d, :c].astype(jnp.float32)).T
    return sp, gs, yX @ bz.T - sp, yX[None] - gs, col_scale


@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("n,d,c", [(300, 17, 16), (260, 300, 9)])
def test_plain_version_matches_pallas_interpret(n, d, c, quantize):
    X, y, Z = _problem(n, d, c)
    sp_j, gs_j, ll_j, g_j, col_scale = _reference_hoisted(X, y, Z, quantize)
    Xt = torch.from_numpy(X) if quantize else torch.from_numpy(X).bfloat16()
    data = glm.prepare_fused_logistic_data(Xt, torch.from_numpy(y), quantize=quantize, device="cpu")
    Z_op = torch.from_numpy(Z * col_scale)
    sp_t, gs_t = glm.fused_hoisted_value_and_grad(data["Xp"], Z_op)
    np.testing.assert_allclose(sp_t.numpy(), sp_j, rtol=1e-5, atol=1e-3)
    assert np.abs(gs_t.numpy() - gs_j).max() <= 1e-4 * np.abs(gs_j).max() + 1e-5
    yX = glm.hoisted_outcomes(data["Xp"], data["yp"], d)
    ll_t, g_t = glm.hoisted_logistic_value_and_grad(data["Xp"], yX, Z_op)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5, atol=1e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-5


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_rebuild_agrees_with_the_one_pass_kernel_at_small_n(quantize):
    n, d, c = 300, 40, 8
    X, y, Z = _problem(n, d, c, seed=2)
    Xt = torch.from_numpy(X) if quantize else torch.from_numpy(X).bfloat16()
    data = glm.prepare_fused_logistic_data(Xt, torch.from_numpy(y), quantize=quantize, device="cpu")
    Z_op = torch.from_numpy(Z)
    if quantize:
        Z_op = Z_op * data["col_scale"]
    yX = glm.hoisted_outcomes(data["Xp"], data["yp"], d)
    ll_h, g_h = glm.hoisted_logistic_value_and_grad(data["Xp"], yX, Z_op)
    ll_k, g_k = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], Z_op)
    assert float((ll_h - ll_k).abs().max()) < 1e-3
    # g: bf16(y - sig) and y - bf16(sig) round differently (one bf16 ulp each)
    assert float((g_h - g_k).abs().max()) <= 1e-2 * float(g_k.abs().max())


def test_cpu_tensors_take_the_plain_version_and_no_sampler_offers_it():
    X, y, Z = _problem(40, 3, 5)
    data = glm.prepare_fused_logistic_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu")
    before = glm.fused_hoisted_vag_cuda.launches
    sp, gs = glm.fused_hoisted_value_and_grad(data["Xp"], torch.from_numpy(Z))
    assert sp.shape == (5,) and gs.shape == (5, 3)
    assert glm.fused_hoisted_vag_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        glm.fused_hoisted_vag_cuda(data["Xp"], torch.from_numpy(Z))
    assert not [name for name in dir(glm) if name.startswith("make_") and "hoisted" in name]
    from mlx_mcmc_tpu_torch.bench import KERNELS

    assert KERNELS["glm_fused_hoisted"] is glm.fused_hoisted_vag_cuda
