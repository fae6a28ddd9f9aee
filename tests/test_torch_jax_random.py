"""The port's threefry streams (numpy) against ``jax.random``, and the port's
GLM generators against the reference's datasets, on the CPU.

``split``, ``bits``, ``uniform`` and ``bernoulli`` must match bit for bit.
``normal`` goes through XLA's float32 ``erf_inv`` and ``log1p``, which the
port reproduces with FMAs formed in float64: all but 1e-5 of its values
must be the same bits and the rest within one ulp. The generators' bounds:
bf16 X mismatches in at most 1e-5 of its elements, true beta within one
float32 ulp, and y differing in at most 5 rows, each one whose uniform lies
within 1e-5 of its probability (the logits are summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.models import glm as ref_glm
from mlx_mcmc_tpu_torch.models import glm, jax_random

SEEDS = [0, 1, 42, 123456789, 2**31 - 1]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in float32 ulps (same-sign values)."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(np.asarray(key), jax_random.prng_key(seed))
    for num in (2, 3, 5):
        assert np.array_equal(np.asarray(jax.random.split(key, num)),
                              jax_random.split(jax_random.prng_key(seed), num))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 3, 5), (1001,), (33, 17)])
def test_bits_and_uniform_bit_for_bit(seed, shape):
    key = jax.random.PRNGKey(seed)
    kk = jax_random.prng_key(seed)
    assert np.array_equal(np.asarray(jax.random.bits(key, shape)), jax_random.bits(kk, shape))
    got = jax_random.uniform(kk, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.array_equal(np.asarray(jax.random.uniform(key, shape)).view(np.uint32),
                          got.view(np.uint32))
    lo, hi = -2.5, 3.0
    assert np.array_equal(np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, hi)).view(np.uint32),
                          jax_random.uniform(kk, shape, lo, hi).view(np.uint32))


@pytest.mark.parametrize("seed", [0, 7])
def test_bernoulli_bit_for_bit(seed):
    p = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    ref = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), jnp.asarray(p)))
    assert np.array_equal(ref, jax_random.bernoulli(jax_random.prng_key(seed), p))


@pytest.mark.parametrize("seed", [0, 3, 123456789])
@pytest.mark.parametrize("shape", [(400_000,), (3, 301, 7)])
def test_normal_within_one_ulp(seed, shape):
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = jax_random.normal(jax_random.prng_key(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    ulps = _ulps(ref, got)
    assert ulps.max() <= 1
    assert (ulps > 0).mean() <= 1e-5


def test_chunked_generation_equals_unchunked(monkeypatch):
    key = jax_random.split(jax_random.prng_key(5), 3)[0]
    whole = (jax_random.normal(key, (301, 113)), jax_random.uniform(key, (301, 113)),
             jax_random.bits(key, (301, 113)))
    monkeypatch.setattr(jax_random, "CHUNK", 1000)  # 35 chunks, the last one short
    chunked = (jax_random.normal(key, (301, 113)), jax_random.uniform(key, (301, 113)),
               jax_random.bits(key, (301, 113)))
    for a, b in zip(whole, chunked):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _check_design(ref, got, data_dtype):
    x_ref = np.asarray(jnp.asarray(ref.X, jnp.float32))
    x_got = got.X.float().numpy()
    assert got.X.dtype == data_dtype and x_got.shape == x_ref.shape
    assert (x_ref != x_got).mean() <= 1e-5
    beta_ref = np.asarray(ref.true_beta)
    beta_got = got.true_beta.numpy()
    assert beta_got.dtype == np.float32 and _ulps(beta_ref, beta_got).max() <= 1
    return x_ref


def _check_logistic(ref, got, seed, data_dtype):
    x_ref = _check_design(ref, got, data_dtype)
    y_ref = np.asarray(ref.y)
    y_got = got.y.numpy()
    diff = np.nonzero(y_ref != y_got)[0]
    assert len(diff) <= 5, len(diff)
    if len(diff):
        # Only rows whose uniform sits on the rounding of its probability.
        key_y = jax_random.split(jax_random.prng_key(seed), 3)[2]
        u = jax_random.uniform(key_y, y_ref.shape)
        p = 1.0 / (1.0 + np.exp(-(x_ref.astype(np.float64) @ np.asarray(ref.true_beta, np.float64))))
        assert np.abs(u[diff] - p[diff]).max() < 1e-5


def test_glm100_dataset_is_the_reference_one():
    ref = ref_glm.make_logistic_regression(100, 10_000, seed=0, data_dtype=jnp.bfloat16)
    got = glm.make_logistic_regression(100, 10_000, seed=0, data_dtype=torch.bfloat16, device="cpu")
    _check_logistic(ref, got, 0, torch.bfloat16)


def test_reduced_glm1000_dataset_is_the_reference_one():
    # glm1000's recipe at D = 1000 with N cut to 2,000 rows.
    ref = ref_glm.make_logistic_regression(1000, 2_000, seed=0, data_dtype=jnp.bfloat16)
    got = glm.make_logistic_regression(1000, 2_000, seed=0, data_dtype=torch.bfloat16, device="cpu")
    _check_logistic(ref, got, 0, torch.bfloat16)


@pytest.mark.parametrize("seed,data_dtype", [(0, torch.bfloat16), (3, torch.float32)])
def test_linear_dataset_is_the_reference_one(seed, data_dtype):
    jdt = jnp.bfloat16 if data_dtype == torch.bfloat16 else jnp.float32
    ref = ref_glm.make_linear_regression(100, 5_000, noise_scale=0.5, seed=seed, data_dtype=jdt)
    got = glm.make_linear_regression(100, 5_000, noise_scale=0.5, seed=seed,
                                     data_dtype=data_dtype, device="cpu")
    _check_design(ref, got, data_dtype)
    # y = X beta + noise: the same noise; X beta summed in another order.
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), rtol=0, atol=2e-5)
