"""The port's threefry streams (numpy) against ``jax.random``, and the port's
GLM and Poisson generators against the reference's datasets, on the CPU.

``split``, ``bits``, ``uniform`` and ``bernoulli`` must match bit for bit.
``normal`` goes through XLA's float32 ``erf_inv`` and ``log1p``, which the
port reproduces with FMAs formed in float64: all but 1e-5 of its values
must be the same bits and the rest within one ulp. ``lgamma`` (XLA's
float32 Lanczos form) must match ``jax.lax.lgamma`` bit for bit on the
integers 1 .. 219,999, and ``poisson`` ``jax.random.poisson`` count for
count. The GLM generators' bounds: bf16 X mismatches in at most 1e-5 of its
elements, true beta within one float32 ulp, and y differing in at most 5
rows, each one whose uniform lies within 1e-5 of its probability (the
logits are summed in another order). The Poisson generator's theta, X and
beta must be the same bits and every count the same. The hierarchical
normal generator's group means and observations must be the same bits, also
at a scale and noise whose products round (where a fused multiply-add
would differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.models import glm as ref_glm
from mlx_mcmc_tpu.models import make_hierarchical_normal as ref_hierarchical_normal
from mlx_mcmc_tpu.models import poisson as ref_poisson
from mlx_mcmc_tpu_torch.models import (
    glm,
    jax_random,
    make_hierarchical_normal,
    make_poisson_event_rates,
)

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


def test_lgamma_bit_for_bit_on_the_integers():
    # Every k + 1 the Poisson sampler's rejection branch can reach at rates
    # up to its 1e5 placeholders.
    x = np.arange(1, 220_000, dtype=np.float32)
    ref = np.asarray(jax.lax.lgamma(jnp.asarray(x)))
    got = jax_random.lgamma(x)
    assert got.dtype == np.float32
    assert np.array_equal(ref.view(np.uint32), got.view(np.uint32))


def test_lgamma_refuses_the_reflection_branch():
    with pytest.raises(ValueError, match="x >= 0.5"):
        jax_random.lgamma(np.array([3.0, 0.25], np.float32))


def _rates(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(0.0, 12.0, 3000),  # both branches around lam = 10
        rng.exponential(40.0, 2000),
        10.0 ** rng.uniform(-3.0, 4.5, 1000),
        np.zeros(50),
        [10.0, np.nextafter(np.float32(10.0), np.float32(0.0)), 1e5],
    ]).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 5, 123456789])
def test_poisson_count_for_count(seed):
    lam = _rates(seed)
    ref = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), jnp.asarray(lam)))
    got = jax_random.poisson(jax_random.prng_key(seed), lam)
    assert got.dtype == np.int32 and got.shape == lam.shape
    assert np.array_equal(ref, got)
    assert not got[lam == 0].any()


@pytest.mark.parametrize("lam", [np.full((7, 11), 3.5, np.float32), np.full((3, 5), 250.0, np.float32)],
                         ids=["knuth_only", "rejection_only"])
def test_poisson_one_branch_arrays(lam):
    ref = np.asarray(jax.random.poisson(jax.random.PRNGKey(9), jnp.asarray(lam)))
    assert np.array_equal(ref, jax_random.poisson(jax_random.prng_key(9), lam))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_poisson1000_cov_dataset_is_the_reference_one(seed):
    ref = ref_poisson.make_poisson_event_rates(1000, 100, 4, seed=seed)
    got = make_poisson_event_rates(1000, 100, 4, seed=seed, device="cpu")
    k_theta = jax.random.split(jax.random.PRNGKey(seed), 4)[0]
    theta = np.asarray(1.0 + 0.5 * jax.random.normal(k_theta, (1000,)))
    assert np.array_equal(theta.view(np.uint32), got.truth["theta"].numpy().view(np.uint32))
    assert np.array_equal(np.asarray(ref.X).view(np.uint32), got.X.numpy().view(np.uint32))
    assert np.array_equal(np.asarray(ref.truth["beta"]).view(np.uint32),
                          got.truth["beta"].numpy().view(np.uint32))
    assert np.array_equal(np.asarray(ref.y), got.y.numpy())  # all 100,000 counts


def test_poisson_rates_dataset_is_the_reference_one():
    ref = ref_poisson.make_poisson_event_rates(200, 30, seed=4)
    got = make_poisson_event_rates(200, 30, seed=4, device="cpu")
    assert got.X is None
    assert np.array_equal(np.asarray(ref.y), got.y.numpy())


def _same_bits(ref, got: torch.Tensor) -> bool:
    return np.array_equal(np.asarray(ref).view(np.uint32), got.numpy().view(np.uint32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hier1000_dataset_is_the_reference_one(seed):
    ref = ref_hierarchical_normal(num_groups=998, obs_per_group=100, seed=seed)
    got = make_hierarchical_normal(num_groups=998, obs_per_group=100, seed=seed, device="cpu")
    assert got.y.shape == (998, 100) and got.y.dtype == torch.float32
    assert _same_bits(ref.y, got.y)  # all 99,800 observations
    k_theta = jax.random.split(jax.random.PRNGKey(seed))[0]
    theta = 1.0 + 0.5 * jax.random.normal(k_theta, (998,))
    assert _same_bits(theta, got.truth["theta"])
    assert (got.truth["mu"], got.truth["tau"]) == (ref.truth["mu"], ref.truth["tau"])


def test_hierarchical_dataset_rounds_as_the_reference():
    # The reference scales and shifts its draws eagerly, one rounding per op;
    # at these values an FMA differs in ~30% of the elements.
    kw = dict(num_groups=37, obs_per_group=50, seed=2, true_mu=1.3, true_tau=0.37, noise_scale=1.7)
    ref = ref_hierarchical_normal(**kw)
    got = make_hierarchical_normal(**kw, device="cpu")
    assert _same_bits(ref.y, got.y)
