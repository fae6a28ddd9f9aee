"""Port parity: the fused GLM value+grad over the reference's whole input
domain, D > 128 (the kernel's two-kernel wide path) and int8 X.

- The plain PyTorch versions against the reference's Pallas kernels in
  interpret mode, at a wide ragged shape, for the logistic (K1) and the
  linear (K2) likelihoods on bf16 X, and for K1 on int8 X with the scales
  folded as the reference folds them (``Bt = bf16(Z col_scale)^T``, g
  times ``col_scale``). Both sides round Z and the residual to bf16 and
  accumulate in float32; only summation order differs. Tolerances as in
  ``test_torch_glm_kernel.py``: ll 1e-3 nats + 1e-5 relative, g 1e-4 of
  max|g| + 1e-5.
- int8 data: the port quantizes exactly as the reference (same int8 values
  and scales from the same float32 X); the reference's int8 pytree converts;
  the int8 vag with its prior against the reference's data-aware non-Pallas
  vag, which rounds neither the scaled Z nor the residual to bf16: ll within
  2e-3 relative (half a bf16 ulp: each scaled coordinate moves by up to
  2^-9 of itself, ~5e-4 of ll at D = 7), g within 1e-2 of max|g| (as the
  bf16-vs-autograd check of the model).
- The launch plan: which kernels a shape and X's type take, that their
  splits cover every row, and that the wide bf16 path's splits do not
  depend on the number of chains. The kernels themselves run on the card
  only (``test_torch_cuda_kernels.py``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import _fused_padded_call
from mlx_mcmc_tpu.ops.pallas.glm import fused_linear_value_and_grad as j_linear
from mlx_mcmc_tpu.ops.pallas.glm import fused_logistic_value_and_grad as j_logistic
from mlx_mcmc_tpu.ops.pallas.glm import make_fused_logistic_vag as j_make_vag
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu_torch.convert import fused_logistic_data_from_jax
from mlx_mcmc_tpu_torch.ops import glm

_TILE = 128


def _problem(n, d, c, seed=0, family="logistic"):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    if family == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
        Z = (beta + rng.standard_normal((c, d))).astype(np.float32)
    else:
        y = (X @ beta + rng.standard_normal(n)).astype(np.float32)
        Z = (beta + 0.3 * rng.standard_normal((c, d))).astype(np.float32)
    return X, y, Z


def _close(ll_t, g_t, ll_j, g_j):
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5, atol=1e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-5


@pytest.mark.parametrize("family", ["logistic", "linear"])
def test_wide_plain_version_matches_pallas_interpret_bf16(family):
    n, d, c = 260, 300, 9
    X, y, Z = _problem(n, d, c, family=family)
    Xb = jnp.asarray(X.astype(ml_dtypes.bfloat16))
    j_fused, prep, port = {
        "logistic": (j_logistic, glm.prepare_fused_logistic_data, glm.fused_logistic_value_and_grad),
        "linear": (j_linear, glm.prepare_fused_linear_data, glm.fused_linear_value_and_grad),
    }[family]
    ll_j, g_j = j_fused(Xb, jnp.asarray(y), jnp.asarray(Z), tile_n=_TILE, interpret=True)
    data = prep(torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu")
    assert data["Xp"].shape == (n, 304)  # Dp = 304 > 128: the wide path on the card
    assert glm.launch_plan(n, 304, c, 132)["path"] == "wide"
    ll_t, g_t = port(data["Xp"], data["yp"], torch.from_numpy(Z))
    _close(ll_t, g_t, ll_j, g_j)


@pytest.mark.parametrize("n,d,c", [(300, 37, 16), (260, 300, 9)])
def test_int8_plain_version_matches_pallas_interpret(n, d, c):
    X, y, Z = _problem(n, d, c, seed=3)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=_TILE, quantize="int8")
    assert jdata["Xp"].dtype == jnp.int8
    col_scale = np.asarray(jdata["col_scale"])
    d_pad, c_pad = jdata["Xp"].shape[1], 128
    Bt = jnp.zeros((d_pad, c_pad), jnp.bfloat16).at[:d, :c].set(
        jnp.asarray(Z * col_scale).astype(jnp.bfloat16).T
    )
    ll_pad, g_pad = _fused_padded_call(jdata["Xp"], jdata["yp"], Bt, _TILE, True)
    ll_j = np.asarray(ll_pad)[0, :c] + float(jdata["pad_const"])
    g_j = np.asarray(g_pad)[:d, :c].T * col_scale

    data = glm.prepare_fused_logistic_data(torch.from_numpy(X), torch.from_numpy(y), quantize="int8",
                                           device="cpu")
    assert data["Xp"].dtype == torch.int8 and data["Xp"].shape == (n, -(-d // 16) * 16)
    scale = data["col_scale"]
    ll_t, g_t = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], torch.from_numpy(Z) * scale)
    _close(ll_t, g_t * scale, ll_j, g_j)


def test_int8_quantization_equals_the_reference():
    X, y, _ = _problem(500, 300, 1, seed=4)
    X[:, 7] = 0.0  # an all-zero column keeps the reference's 1e-30 floor
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=_TILE, quantize="int8")
    data = glm.prepare_fused_logistic_data(torch.from_numpy(X), torch.from_numpy(y), quantize="int8",
                                           device="cpu")
    np.testing.assert_array_equal(data["col_scale"].numpy(), np.asarray(jdata["col_scale"]))
    np.testing.assert_array_equal(data["Xp"][:, :300].numpy(), np.asarray(jdata["Xp"])[:500, :300])
    assert not data["Xp"][:, 300:].any()
    with pytest.raises(ValueError, match="quantize"):
        glm.prepare_fused_logistic_data(X, y, quantize="int4", device="cpu")


def test_int8_pytree_converts_from_jax():
    X, y, _ = _problem(50, 4, 1)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=64, quantize="int8")
    tdata = fused_logistic_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    assert tdata["Xp"].dtype == torch.int8 and tdata["Xp"].shape == (64, 128)  # padded rows kept
    np.testing.assert_array_equal(tdata["Xp"].numpy(), np.asarray(jdata["Xp"]))
    np.testing.assert_array_equal(tdata["col_scale"].numpy(), np.asarray(jdata["col_scale"]))
    assert tdata["pad_const"] == pytest.approx(14 * np.log(2.0), rel=1e-6)


@pytest.mark.parametrize("d", [7, 150])
def test_int8_vag_matches_reference_non_pallas_through_convert(d):
    n, c = 300, 12
    X, y, Z = _problem(n, d, c, seed=5)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=_TILE, quantize="int8")
    jvag = j_make_vag(prior_scale=2.0, data_aware=True, use_pallas=False)
    ll_j, g_j = jax.vmap(lambda z: jvag(z, jdata))(jnp.asarray(Z))
    tdata = fused_logistic_data_from_jax({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    ll_t, g_t = glm.make_fused_logistic_vag(prior_scale=2.0)(torch.from_numpy(Z), tdata)
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=2e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-2 * np.abs(g_j).max()
    # The port's own unpadded int8 data give the same values.
    own = glm.prepare_fused_logistic_data(torch.from_numpy(X), torch.from_numpy(y), quantize="int8",
                                          device="cpu")
    ll_o, g_o = glm.make_fused_logistic_vag(prior_scale=2.0)(torch.from_numpy(Z), own)
    np.testing.assert_allclose(ll_o.numpy(), ll_t.numpy(), rtol=1e-5)
    np.testing.assert_allclose(g_o.numpy(), g_t.numpy(), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("n,d_pad,c", [(10_000, 112, 4096), (100_000, 1008, 256), (777, 304, 70),
                                       (1, 16, 65), (129, 144, 1), (5000, 128, 3)])
def test_launch_plan_covers_every_row(n, d_pad, c, x_dtype):
    plan = glm.launch_plan(n, d_pad, c, 132, x_dtype)
    if x_dtype == torch.float32:
        path = "f32"
    elif d_pad <= 128:
        path = "narrow"
    else:
        path = "wide_int8" if x_dtype == torch.int8 else "wide"
    assert plan["path"] == path
    tiles = {"narrow": (64, 64), "wide": (128, 64), "wide_int8": (128, 32), "f32": (64, 16)}[path]
    for (s, r), tile in zip([("splits", "rows_per_split"), ("g_splits", "g_rows_per_split")], tiles):
        splits, rows = plan[s], plan[r]
        assert rows % tile == 0 and splits * rows >= n > (splits - 1) * rows
    c64, c256 = -(-c // 64) * 64, -(-c // 256) * 256
    if path == "wide":
        assert plan["zb_shape"] == (c256, d_pad)
        assert plan["rt_shape"] == (c256, -(-n // 128) * 128) and plan["rt_dtype"] == torch.bfloat16
    elif path == "wide_int8":
        assert plan["zb_shape"] == (c64, d_pad)
        assert plan["rt_shape"] == (c64, -(-n // 128) * 128) and plan["rt_dtype"] == torch.bfloat16
    elif path == "f32":
        assert plan["zb_shape"] is None
        assert plan["rt_shape"] == (c64, -(-n // 64) * 64) and plan["rt_dtype"] == torch.float32
    else:
        # bf16: the TMA + wgmma kernel reads Z as bf16 (chains padded to 128)
        assert plan["g_splits"] == plan["splits"] and plan["rt_shape"] is None
        c128 = -(-c // 128) * 128
        assert plan["zb_shape"] == ((c128, d_pad) if x_dtype == torch.bfloat16 else None)


@pytest.mark.parametrize("x_dtype,n,d_pad,path", [
    (torch.bfloat16, 10_000, 112, "narrow"), (torch.bfloat16, 777, 48, "narrow"),
    (torch.bfloat16, 1, 16, "narrow"), (torch.int8, 10_000, 112, "narrow"),
    (torch.int8, 777, 128, "narrow"), (torch.float32, 10_000, 112, "f32"),
    (torch.float32, 777, 304, "f32"), (torch.int8, 100_000, 1008, "wide_int8"),
    (torch.int8, 777, 304, "wide_int8"), (torch.bfloat16, 100_000, 1008, "wide"),
    (torch.bfloat16, 777, 304, "wide"), (torch.bfloat16, 129, 144, "wide"),
    (torch.bfloat16, 5000, 2048, "wide"),
])
def test_wide_plan_splits_do_not_depend_on_the_chain_count(x_dtype, n, d_pad, path):
    # Every path: the row splits of both products are the same at every C,
    # so a chain's ll and g are summed in one order whatever the batch.
    keys = ("splits", "rows_per_split", "g_splits", "g_rows_per_split")
    plans = [glm.launch_plan(n, d_pad, c, 132, x_dtype) for c in (1, 4, 70, 256, 300, 4096)]
    assert {p["path"] for p in plans} == {path}
    assert len({tuple(p[k] for k in keys) for p in plans}) == 1
    plan = plans[0]
    if path == "wide":
        # One block per SM for one chain tile: row tiles over the SMs, and
        # the gradient's row splits times its column tiles of 128 within the
        # SMs.
        assert plan["splits"] <= 132
        assert plan["g_splits"] * -(-d_pad // 128) <= 132
    if path == "narrow":
        # At most four splits: the g partials stay 4 x C x Dp x 4 bytes.
        assert plan["splits"] == min(4, -(-n // 64))
