"""Port parity: flat-parameter ravel and Welford moments against JAX.

Tolerance: 1e-6 (float32 arithmetic in the same order; only reduction
order differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops import math as jmath
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu.ops.ravel import ravel_params as j_ravel_params
from mlx_mcmc_tpu_torch.ops import math as tmath
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob, ravel_params

TOL = 1e-6


def _params(rng):
    # Insertion order differs from sorted order on purpose.
    return {
        "zeta": rng.standard_normal((2, 3)),  # float64 numpy -> float32
        "alpha": 3,  # int -> float32
        "mid": np.float64(0.25),
        "beta": rng.standard_normal(4).astype(np.float32),
    }


def test_ravel_matches_jax_order_and_dtype():
    params = _params(np.random.default_rng(0))
    flat_t, unravel = ravel_params(params, device="cpu")
    flat_j, _ = j_ravel_params(params)
    assert flat_t.dtype == torch.float32
    assert flat_j.dtype == jnp.float32
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unravel(flat_t)
    assert list(back) == ["alpha", "beta", "mid", "zeta"]
    for k, v in params.items():
        np.testing.assert_allclose(back[k].numpy(), np.asarray(v, np.float32), rtol=0)
        assert back[k].shape == np.shape(v)


def test_nested_dicts_flatten_like_jax():
    params = {"b": {"y": np.ones(2), "x": 2.0}, "a": np.arange(3)}
    flat_t, unravel = ravel_params(params, device="cpu")
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(j_ravel_params(params)[0]))
    back = unravel(flat_t)
    assert float(back["b"]["x"]) == 2.0 and back["b"]["y"].shape == (2,)


def test_unravel_keeps_batch_axes():
    params = {"b": np.zeros(3), "a": 0.0}
    _, unravel = ravel_params(params, device="cpu")
    z = torch.arange(2 * 5 * 4, dtype=torch.float32).reshape(2, 5, 4)
    out = unravel(z)
    assert out["a"].shape == (2, 5)
    assert out["b"].shape == (2, 5, 3)
    assert torch.equal(out["a"], z[..., 0])
    assert torch.equal(out["b"], z[..., 1:])


def test_flat_logprob_nan_becomes_minus_inf():
    def lp(p):
        return torch.log(p["x"] - 10.0).sum()  # NaN for x < 10

    flp, z0, _ = make_flat_logprob(lp, {"x": np.zeros(2)}, device="cpu")
    assert flp(z0).item() == -np.inf

    def jlp(p):
        return jnp.sum(jnp.log(p["x"] - 10.0))

    jflp, jz0, _ = j_make_flat_logprob(jlp, {"x": np.zeros(2)})
    assert float(jflp(jz0)) == -np.inf


def _welford_np(state):
    return [np.asarray(x) for x in state]


def _assert_welford(t_state, j_state):
    for a, b in zip(t_state, _welford_np(j_state)):
        np.testing.assert_allclose(a.numpy(), b, rtol=TOL, atol=TOL)


def test_welford_update_batch_merge_finalize_match_jax():
    rng = np.random.default_rng(1)
    xs1 = rng.standard_normal((17, 5)).astype(np.float32)
    xs2 = (3.0 + 2.0 * rng.standard_normal((9, 5))).astype(np.float32)

    t = tmath.welford_init(5, device="cpu")
    j = jmath.welford_init(5)
    for x in xs1[:4]:
        t = tmath.welford_update(t, torch.from_numpy(x))
        j = jmath.welford_update(j, jnp.asarray(x))
    _assert_welford(t, j)

    t = tmath.welford_batch_update(t, torch.from_numpy(xs1[4:]))
    j = jmath.welford_batch_update(j, jnp.asarray(xs1[4:]))
    _assert_welford(t, j)

    t2 = tmath.welford_batch_update(tmath.welford_init(5, device="cpu"), torch.from_numpy(xs2))
    j2 = jmath.welford_batch_update(jmath.welford_init(5), jnp.asarray(xs2))
    tm = tmath.welford_merge(t, t2)
    jm = jmath.welford_merge(j, j2)
    _assert_welford(tm, jm)

    for reg in (True, False):
        np.testing.assert_allclose(
            tmath.welford_finalize(tm, regularize=reg).numpy(),
            np.asarray(jmath.welford_finalize(jm, regularize=reg)),
            rtol=TOL,
        )
    # Fewer than two observations: unit variance, as in the reference.
    one = tmath.welford_update(tmath.welford_init(3, device="cpu"), torch.ones(3))
    np.testing.assert_array_equal(tmath.welford_finalize(one).numpy(), np.ones(3))
    # Pooled moments equal the plain ones.
    allx = np.concatenate([xs1, xs2])
    np.testing.assert_allclose(tm.mean.numpy(), allx.mean(0), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("value", [-1.0, 0.5, 2.0])
def test_safe_where_log_prob_matches_jax(value):
    def f_t(v):
        return torch.log(v)

    out_t = tmath.safe_where_log_prob(
        torch.tensor(value) > 0, torch.tensor(value), 1.0, f_t
    )
    out_j = jmath.safe_where_log_prob(jnp.asarray(value) > 0, value, 1.0, jnp.log)
    assert float(out_t) == pytest.approx(float(out_j))
    # Zero (not NaN) gradient outside the support.
    v = torch.tensor(value, requires_grad=True)
    out = tmath.safe_where_log_prob(v > 0, v, 1.0, f_t)
    if value <= 0:
        out = torch.where(torch.isinf(out), torch.zeros(()), out)
    out.backward()
    assert torch.isfinite(v.grad)


@pytest.mark.parametrize("shape", [(4, 1006), (1, 3), (20, 100), (5, 7, 33)])
def test_row_sum_is_the_last_axis_sum(shape):
    # row_sum only changes how the card orders a batch of fewer than 16
    # rows; on the CPU, and for every shape, it is x.sum(-1).
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(shape).astype(np.float32))
    np.testing.assert_array_equal(tmath.row_sum(x).numpy(), x.sum(-1).numpy())
    y = jnp.asarray(x.numpy()).sum(-1)
    np.testing.assert_allclose(tmath.row_sum(x).numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
