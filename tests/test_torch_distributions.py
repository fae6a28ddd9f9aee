"""Port parity of the distributions against JAX.

Normal to 1e-6 relative. HalfNormal, Exponential, Gamma, Beta and
Categorical: ``log_prob`` inside and outside the support and under
broadcasting, and the moments, against the JAX classes to float32
tolerance (1e-5 relative + 1e-5 absolute: ``lgamma`` and ``log1p`` may
differ in the last float32 bits between XLA and PyTorch); ``-inf`` outside
the support with a zero gradient there (the double-where); evaluation
under ``torch.func.vmap``, as the engine batches a model; samples by a
Kolmogorov-Smirnov test against scipy's distribution (p > 1e-3 at 20,000
draws from a fixed seed) and Categorical's by frequencies.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as sps
import torch

import mlx_mcmc_tpu.distributions as jd
from mlx_mcmc_tpu.distributions import Normal as JNormal
from mlx_mcmc_tpu_torch.distributions import (
    Beta,
    Categorical,
    Exponential,
    Gamma,
    HalfNormal,
    Normal,
)


@pytest.mark.parametrize(
    "loc,scale",
    [(0.0, 1.0), (1.5, 10.0), (np.array([0.0, 1.0, -2.0]), 2.0),
     (0.5, np.array([0.5, 1.0, 3.0]))],
)
def test_normal_log_prob_matches_jax(loc, scale):
    x = np.random.default_rng(0).standard_normal(3).astype(np.float32) * 3
    t_loc = torch.as_tensor(loc, dtype=torch.float32) if isinstance(loc, np.ndarray) else loc
    t_scale = torch.as_tensor(scale, dtype=torch.float32) if isinstance(scale, np.ndarray) else scale
    out_t = Normal(t_loc, t_scale).log_prob(torch.from_numpy(x))
    out_j = JNormal(jnp.asarray(loc, jnp.float32), jnp.asarray(scale, jnp.float32)).log_prob(x)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_normal_python_float_scale_edges():
    x = torch.tensor([0.3])
    assert torch.isnan(Normal(0.0, -1.0).log_prob(x)).all()
    assert np.isnan(float(JNormal(0.0, -1.0).log_prob(0.3)))
    assert Normal(0.0, 1.0).batch_shape == ()
    assert Normal(torch.zeros(4), 1.0).batch_shape == (4,)


def test_normal_sample_uses_generator():
    gen = torch.Generator().manual_seed(3)
    a = Normal(1.0, 2.0).sample(gen, (20000,))
    gen.manual_seed(3)
    b = Normal(1.0, 2.0).sample(gen, (20000,))
    assert torch.equal(a, b)
    assert abs(a.mean().item() - 1.0) < 0.05
    assert abs(a.std().item() - 2.0) < 0.05
    assert Normal(torch.zeros(3), 1.0).sample(gen, 5).shape == (5, 3)


def test_normal_moments_match_jax():
    loc, scale = np.array([0.0, 2.0], np.float32), np.array([1.0, 3.0], np.float32)
    t = Normal(torch.from_numpy(loc), torch.from_numpy(scale))
    j = JNormal(jnp.asarray(loc), jnp.asarray(scale))
    for name in ("mean", "variance", "mode", "entropy"):
        np.testing.assert_allclose(
            getattr(t, name)().numpy(), np.asarray(getattr(j, name)()), rtol=1e-6
        )


RTOL = ATOL = 1e-5

# (name, parameters as numpy, values inside and outside the support)
CASES = [
    ("HalfNormal", (1.7,), [0.0, 0.3, 2.1, 7.0, -0.5, -1e-6]),
    ("HalfNormal", (np.array([0.5, 1.0, 3.0], np.float32),), [0.2, 1.5, -0.1]),
    ("Exponential", (3.0,), [0.0, 0.01, 1.3, 4.0, -0.01, -2.0]),
    ("Exponential", (np.array([0.5, 2.0], np.float32),), [[0.7, 0.1], [-1.0, 3.0]]),
    ("Gamma", (3.0, 2.0), [0.2, 1.0, 3.5, 0.0, -1.0]),
    ("Gamma", (np.array([0.5, 1.0, 4.0], np.float32), 1.5), [0.05, 2.0, 9.0]),
    ("Gamma", (2.5, np.array([0.5, 3.0], np.float32)), [[0.4], [1.2], [-0.3]]),
    ("Beta", (2.0, 5.0), [0.1, 0.5, 0.9, 0.0, 1.0, -0.1, 1.1]),
    ("Beta", (np.array([0.5, 2.0, 8.0], np.float32), np.array([0.5, 3.0, 1.5], np.float32)),
     [0.01, 0.6, 0.999]),
]


def _pair(name, params):
    t_params = [torch.from_numpy(p) if isinstance(p, np.ndarray) else p for p in params]
    j_params = [jnp.asarray(p) if isinstance(p, np.ndarray) else p for p in params]
    return globals()[name](*t_params), getattr(jd, name)(*j_params)


@pytest.mark.parametrize("name,params,values", CASES)
def test_log_prob_matches_jax(name, params, values):
    t, j = _pair(name, params)
    x = np.asarray(values, np.float32)
    out_t = t.log_prob(torch.from_numpy(x)).numpy()
    out_j = np.asarray(j.log_prob(jnp.asarray(x)))
    assert out_t.shape == out_j.shape
    assert np.array_equal(np.isneginf(out_t), np.isneginf(out_j))
    finite = np.isfinite(out_j)
    assert finite.any()
    np.testing.assert_allclose(out_t[finite], out_j[finite], rtol=RTOL, atol=ATOL)
    assert t.batch_shape == tuple(j.batch_shape)


@pytest.mark.parametrize("name,params,bad", [
    ("HalfNormal", (1.0,), -0.5), ("Exponential", (1.0,), -0.5), ("Gamma", (2.0, 1.0), -1.0),
    ("Gamma", (2.0, 1.0), 0.0), ("Beta", (2.0, 2.0), -0.1), ("Beta", (2.0, 2.0), 1.0),
])
def test_outside_support_is_neg_inf_with_zero_gradient(name, params, bad):
    t, _ = _pair(name, params)
    x = torch.tensor(bad, requires_grad=True)
    lp = t.log_prob(x)
    (g,) = torch.autograd.grad(lp, x)
    assert float(lp.detach()) == -math.inf
    assert float(g) == 0.0


def test_parameter_gradients_are_finite():
    a = torch.tensor(2.0, requires_grad=True)
    (g,) = torch.autograd.grad(Beta(a, 2.0).log_prob(torch.tensor(0.3)), a)
    g_j = jax.grad(lambda a: jd.Beta(a, 2.0).log_prob(0.3))(2.0)
    np.testing.assert_allclose(float(g), float(g_j), rtol=1e-4)
    b = torch.tensor(3.0, requires_grad=True)
    (g,) = torch.autograd.grad(Gamma(b, 2.0).log_prob(torch.tensor(0.7)), b)
    g_j = jax.grad(lambda a: jd.Gamma(a, 2.0).log_prob(0.7))(3.0)
    np.testing.assert_allclose(float(g), float(g_j), rtol=1e-4)


@pytest.mark.parametrize("name,params", [
    ("HalfNormal", (np.array([0.5, 2.0], np.float32),)),
    ("Exponential", (np.array([0.5, 4.0], np.float32),)),
    ("Gamma", (np.array([0.5, 3.0], np.float32), np.array([2.0, 0.5], np.float32))),
    ("Beta", (np.array([0.5, 2.0], np.float32), np.array([0.5, 5.0], np.float32))),
])
def test_moments_match_jax(name, params):
    t, j = _pair(name, params)
    names = ["mean", "variance", "mode"] + {"Exponential": ["median"], "Beta": ["entropy"]}.get(
        name, [])
    for m in names:
        np.testing.assert_allclose(getattr(t, m)().numpy(), np.asarray(getattr(j, m)()),
                                   rtol=RTOL, atol=ATOL, equal_nan=True)


def test_log_prob_under_vmap():
    """The engine batches a model with ``torch.func.vmap`` over chains."""
    def model(z):
        return (HalfNormal(2.0).log_prob(z[0]) + Exponential(1.5).log_prob(z[1])
                + Gamma(2.0, 1.0).log_prob(z[2]) + Beta(2.0, 3.0).log_prob(z[3])
                + Categorical(logits=torch.tensor([0.1, 0.5, -0.3])).log_prob(z[4]))

    Z = torch.tensor([[0.5, 0.5, 0.5, 0.5, 1.0], [-1.0, 2.0, 1.0, 0.2, 2.0],
                      [1.0, 1.0, 1.0, 0.7, 3.0]])
    out = torch.func.vmap(model)(Z)
    rows = torch.stack([model(z) for z in Z])
    torch.testing.assert_close(out, rows, rtol=0, atol=0)
    assert out[1] == -math.inf and out[2] == -math.inf and torch.isfinite(out[0])


@pytest.mark.parametrize("name,params,scipy_dist", [
    ("HalfNormal", (2.0,), sps.halfnorm(scale=2.0)),
    ("Exponential", (2.0,), sps.expon(scale=0.5)),
    ("Gamma", (3.0, 2.0), sps.gamma(3.0, scale=0.5)),
    ("Gamma", (0.4, 1.0), sps.gamma(0.4)),
    ("Beta", (2.0, 5.0), sps.beta(2.0, 5.0)),
    ("Beta", (0.5, 0.5), sps.beta(0.5, 0.5)),
])
def test_samples_ks_against_scipy(name, params, scipy_dist):
    t, _ = _pair(name, params)
    gen = torch.Generator().manual_seed(13)
    xs = t.sample(gen, (20000,))
    assert xs.shape == (20000,) and xs.dtype == torch.float32
    assert sps.kstest(xs.numpy(), scipy_dist.cdf).pvalue > 1e-3
    gen.manual_seed(13)
    assert torch.equal(xs, t.sample(gen, (20000,)))


def test_batched_sample_shapes():
    gen = torch.Generator().manual_seed(0)
    assert HalfNormal(torch.ones(3)).sample(gen, 5).shape == (5, 3)
    assert Gamma(torch.ones(2), 1.0).sample(gen, (4, 7)).shape == (4, 7, 2)
    assert Beta(2.0, torch.ones(3)).sample(gen).shape == (3,)
    assert Categorical(logits=torch.zeros(2, 4)).sample(gen, 6).shape == (6, 2)


def test_categorical_matches_jax():
    probs = np.array([[0.5, 0.3, 0.2], [0.1, 0.1, 0.8]], np.float32)
    for kw_t, kw_j in [({"probs": torch.from_numpy(probs)}, {"probs": jnp.asarray(probs)}),
                       ({"logits": torch.from_numpy(np.log(probs) + 2.0)},
                        {"logits": jnp.asarray(np.log(probs) + 2.0)})]:
        t, j = Categorical(**kw_t), jd.Categorical(**kw_j)
        # (3, 2) values broadcast against the (2,) batch; the reference
        # takes one (2,) row at a time
        v = np.array([[0, 2], [1, 1], [2, 0]], np.float32)
        out = t.log_prob(torch.from_numpy(v)).numpy()
        for row, row_out in zip(v, out):
            np.testing.assert_allclose(row_out, np.asarray(j.log_prob(jnp.asarray(row))),
                                       rtol=RTOL)
        np.testing.assert_allclose(t.entropy().numpy(), np.asarray(j.entropy()), rtol=RTOL)
        np.testing.assert_array_equal(t.mode().numpy(), np.asarray(j.mode()))
        np.testing.assert_allclose(t.probs.numpy(), np.asarray(j.probs), rtol=RTOL)
    one = Categorical(probs=[2.0, 2.0, 4.0])
    jone = jd.Categorical(probs=[2.0, 2.0, 4.0])
    for v in (0, 2, -1, 3, 1.5):
        np.testing.assert_allclose(float(one.log_prob(v)), float(jone.log_prob(v)), rtol=RTOL)
    assert float(one.log_prob(-1)) == -math.inf and float(one.log_prob(1.5)) == -math.inf
    with pytest.raises(ValueError):
        Categorical()
    with pytest.raises(ValueError):
        Categorical(probs=[0.5, 0.5], logits=[0.0, 0.0])


def test_categorical_frequencies():
    probs = np.array([0.5, 0.3, 0.2])
    xs = Categorical(probs=probs).sample(torch.Generator().manual_seed(3), (20000,))
    freqs = np.bincount(xs.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(freqs, probs, atol=0.015)
