"""Port parity: the fused GLM value+grad on f32 X (K1 logistic, K2 linear,
K4 hoisted).

The reference's kernels take f32 X (``x_ref`` is "f32, bf16, or int8",
mlx_mcmc_tpu/ops/pallas/glm.py:87) and round nothing then: ``Bt`` is Z in
f32 and the residual is cast to X's type. The port's plain versions on f32
X against the reference's Pallas kernel bodies in interpret mode, at ragged
shapes including D > 128: ll within the reference's own f32 tolerance
(rtol 2e-5, tests/test_pallas.py), g within rtol 2e-4 and atol 2e-5 of the
same test. Both sides accumulate in float32; only summation order differs.

The CUDA kernels compute both products in 3xTF32 (each operand split into
two tf32 parts). Here, without a card: the plain model of that split
(``glm.split_tf32``), a plain model of the kernels' arithmetic
(``_tf32x3_vag``) against the reference's kernels under the same f32
tolerances, the launch plan's batch invariance, and the X^T that f32 data
carry for the gradient kernel (``XpT``). The CUDA kernels
against the plain versions and float64: ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import _fused_hoisted_kernel, _fused_padded_call
from mlx_mcmc_tpu.ops.pallas.glm import fused_linear_value_and_grad as j_linear
from mlx_mcmc_tpu.ops.pallas.glm import fused_logistic_value_and_grad as j_logistic
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_linear_data as j_prepare_linear
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu_torch.convert import fused_linear_data_from_jax, fused_logistic_data_from_jax
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


def _tf32x3_vag(Xp, y, Z, epilogue):
    """Both products as three float32 products of the tf32 parts, summed in
    float32: ``s = Z_hi X_lo^T + Z_lo X_hi^T + Z_hi X_hi^T``, ``g = R_hi
    X_lo + R_lo X_hi + R_hi X_hi``. The kernels' arithmetic, not their
    summation order."""
    d = Z.shape[1]
    xh, xl = glm.split_tf32(Xp[:, :d])
    zh, zl = glm.split_tf32(Z)
    s = zh @ xl.T + zl @ xh.T + zh @ xh.T
    term, res = epilogue(y, s)
    rh, rl = glm.split_tf32(res)
    return term.sum(dim=-1), rh @ xl + rl @ xh + rh @ xh


def _tf32_bits(x):
    return x.contiguous().view(torch.int32)


def test_split_tf32_rounds_to_nearest_tf32():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4000).astype(np.float32) * np.float32(10.0) ** rng.integers(-6, 6, 4000),
        [0.0, -0.0, 1.0, -1.0, 3.0e-30, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 3 * 2.0**-12],
    ]).astype(np.float32))
    hi, lo = glm.split_tf32(x)
    # Both parts are tf32 values: the low 13 bits of each are zero.
    assert int((_tf32_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_tf32_bits(lo) & 0x1FFF).abs().max()) == 0
    xd, hd, ld = x.double(), hi.double(), lo.double()
    # hi is x to nearest (half a tf32 ulp, 2^-11 relative); Veltkamp's split
    # in round-to-nearest-even float32 sends the halfway cases to the even
    # neighbour.
    assert bool(((xd - hd).abs() <= 2.0**-11 * xd.abs()).all())
    assert hi[-3] == 1.0 and hi[-2] == 1.0 + 2.0**-9 and hi[-1] == 1.0 + 2.0**-10
    # lo is x - hi (exact in f32) to nearest tf32, so hi + lo is x within
    # tf32(lo)'s rounding: half an ulp of lo, ~2^-22 of x.
    assert bool(((xd - hd - ld).abs() <= 2.0**-11 * (xd - hd).abs()).all())
    assert bool(((xd - hd - ld).abs() <= 2.0**-22 * xd.abs()).all())
    assert glm.split_tf32(torch.zeros(3))[1].abs().max() == 0


def test_split_tf32_commutes_with_transpose():
    # The gradient kernel splits X^T, the value kernel X: the same parts.
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((37, 19)).astype(np.float32))
    for a, b in zip(glm.split_tf32(X.T), glm.split_tf32(X)):
        assert torch.equal(a, b.T)


@pytest.mark.parametrize("family", ["logistic", "linear", "hoisted"])
@pytest.mark.parametrize("n,d,c", [(300, 17, 5), (257, 37, 33), (260, 300, 9)])
def test_tf32x3_model_matches_pallas_interpret_f32(n, d, c, family):
    # Three float32 products of the tf32 parts, summed in float32, meet the
    # reference's own f32 tolerances on f32 X, D > 128 included: the split
    # the kernels use keeps f32-class accuracy.
    X, y, Z = _problem(n, d, c, family, seed=5)
    ll_j, g_j = (np.asarray(a) for a in _reference(family, X, y, Z))
    prep = glm.prepare_fused_linear_data if family == "linear" else glm.prepare_fused_logistic_data
    data = prep(torch.from_numpy(X), torch.from_numpy(y), device="cpu")
    epilogue = {"logistic": glm._logistic_epilogue, "linear": glm._gaussian_epilogue,
                "hoisted": glm._hoisted_epilogue}[family]
    ll_t, g_t = _tf32x3_vag(data["Xp"], data["yp"], torch.from_numpy(Z), epilogue)
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=2e-5)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("n,d_pad", [(10_000, 112), (100_000, 1008), (777, 304), (1, 16), (129, 144)])
def test_f32_plan_splits_do_not_depend_on_the_chain_count(n, d_pad):
    keys = ("splits", "rows_per_split", "g_splits", "g_rows_per_split")
    plans = {c: glm.launch_plan(n, d_pad, c, 132, torch.float32) for c in (4, 70, 256, 4096)}
    assert {p["path"] for p in plans.values()} == {"f32"}
    assert plans[4][keys[0]] == plans[4096][keys[0]]
    assert len({tuple(p[k] for k in keys) for p in plans.values()}) == 1
    plan = plans[4096]
    # One chain tile's value items fill the SMs; the gradient's splits keep
    # at least 512 rows each (the last may be short) within the SMs left to
    # each column tile of 128.
    assert plan["splits"] <= 132 and plan["rows_per_split"] % 128 == 0
    assert plan["g_rows_per_split"] % 32 == 0
    assert plan["g_splits"] * -(-d_pad // 128) <= 132
    assert plan["g_splits"] <= max(1, -(-n // 512))
    # Both kernels run on persistent grids of one block per SM at most.
    assert plan["grid"] == 132


@pytest.mark.parametrize("source", ["port", "reference"])
@pytest.mark.parametrize("family", ["logistic", "linear"])
@pytest.mark.parametrize("n,d", [(1, 5), (257, 37), (260, 300)])
def test_f32_data_carry_their_transpose(n, d, family, source):
    # The f32 gradient kernel reads X^T (a tf32 wgmma takes B K-major only):
    # f32 data carry it, made once with Xp, (Dp, N rounded up to 4) with
    # zeros past N; bf16 and int8 data carry none.
    X, y, _ = _problem(n, d, 1, family)
    if source == "port":
        prep = glm.prepare_fused_linear_data if family == "linear" else glm.prepare_fused_logistic_data
        data = prep(torch.from_numpy(X), torch.from_numpy(y), device="cpu")
        others = [prep(torch.from_numpy(X).bfloat16(), torch.from_numpy(y), device="cpu")]
        if family == "logistic":
            others.append(prep(torch.from_numpy(X), torch.from_numpy(y), quantize="int8", device="cpu"))
        assert all("XpT" not in o for o in others)
    else:
        j_prep, convert = ((j_prepare_linear, fused_linear_data_from_jax) if family == "linear"
                           else (j_prepare, fused_logistic_data_from_jax))
        jdata = j_prep(jnp.asarray(X), jnp.asarray(y), tile_n=_TILE)
        data = convert({k: np.asarray(v) for k, v in jdata.items()}, device="cpu")
    Xp, XpT = data["Xp"], data["XpT"]
    rows, d_pad = Xp.shape
    assert Xp.dtype == XpT.dtype == torch.float32 and XpT.is_contiguous()
    assert XpT.shape == (d_pad, -(-rows // 4) * 4)
    assert torch.equal(XpT[:, :rows], Xp.T) and not XpT[:, rows:].any()
    assert torch.equal(glm.transpose_f32(Xp), XpT)
