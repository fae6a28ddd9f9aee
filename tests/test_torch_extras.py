"""The eleven distributions of ``distributions/extras.py`` against the
reference's ``mlx_mcmc_tpu/distributions/extras.py``, after
``tests/test_extras.py``.

- ``log_prob`` at ``tests/test_extras.py``'s points (and a few more, with
  tensor parameters and batched values) equals the reference's to 1e-5
  relative and 1e-6 absolute, ``-inf`` where the reference gives it
  (outside the support), and the XOR-argument errors are the reference's.
- ``log_prob`` runs under ``torch.func.vmap`` (as the engine evaluates a
  model) and its gradient at a support edge is 0, not NaN.
- The reference's sampling-moment checks, from an explicit
  ``torch.Generator`` (the same laws, other streams).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_mcmc_tpu as ref
import mlx_mcmc_tpu_torch as port

N = 10_000

# (name, args, kwargs, values): the reference's points and the edges.
_CASES = [
    ("Bernoulli", (), dict(probs=0.3), [1.0, 0.0, 0.5, -1.0]),
    ("Bernoulli", (), dict(logits=[-1.0, 2.0]), [[1.0, 0.0], [0.0, 0.0]]),
    ("Uniform", (2.0, 5.0), {}, [3.0, 5.5, 1.9, 2.0, 5.0]),
    ("LogNormal", (0.5, 0.8), {}, [0.2, 1.0, 4.2, 0.0, -1.0]),
    ("StudentT", (4.0, 1.0, 2.0), {}, [-2.0, 0.0, 3.0, 40.0]),
    ("StudentT", ([3.0, 7.5], 0.0, [1.0, 0.5]), {}, [[-2.0, 0.3], [1.0, 9.0]]),
    ("Poisson", (3.5,), {}, [0.0, 3.0, 10.0, -1.0, 1.5]),
    ("Poisson", ([0.5, 20.0],), {}, [[0.0, 25.0], [2.0, 1.0]]),
    ("Dirichlet", ([2.0, 3.0, 4.0],), {}, [[0.2, 0.3, 0.5], [0.5, 0.6, -0.1], [0.1, 0.1, 0.1]]),
    ("MultivariateNormal", ([1.0, -1.0],), dict(covariance_matrix=[[2.0, 0.5], [0.5, 1.0]]),
     [[0.3, 0.2], [-4.0, 3.0]]),
    ("MultivariateNormal", ([0.0, 0.0, 1.0],),
     dict(scale_tril=[[1.0, 0.0, 0.0], [0.5, 2.0, 0.0], [-0.3, 0.1, 0.7]]),
     [[0.3, 0.2, 0.1]]),
    ("Laplace", (0.5, 1.5), {}, [-2.0, 0.5, 3.0]),
    ("Cauchy", (1.0, 2.0), {}, [-3.0, 0.0, 2.0, 1e4]),
    ("Binomial", (10,), dict(probs=0.3), [0.0, 3.0, 10.0, 11.0, -1.0, 2.5]),
    ("Binomial", (5,), dict(logits=0.4), [0.0, 5.0, 6.0]),
    ("NegativeBinomial", (4.0, 0.4), {}, [0.0, 2.0, 7.0, -1.0, 1.5]),
]


def _ids():
    seen = {}
    out = []
    for name, *_ in _CASES:
        seen[name] = seen.get(name, 0) + 1
        out.append(f"{name}-{seen[name]}")
    return out


def _port_arg(x):
    return torch.tensor(x, dtype=torch.float32) if isinstance(x, list) else x


@pytest.mark.parametrize("name,args,kwargs,values", _CASES, ids=_ids())
def test_log_prob_matches_the_reference(name, args, kwargs, values):
    j = getattr(ref, name)(*(jnp.asarray(a) if isinstance(a, list) else a for a in args),
                           **{k: jnp.asarray(v) if isinstance(v, list) else v
                              for k, v in kwargs.items()})
    t = getattr(port, name)(*map(_port_arg, args), **{k: _port_arg(v) for k, v in kwargs.items()})
    for v in values:
        want = np.asarray(j.log_prob(jnp.asarray(v, jnp.float32)))
        got = t.log_prob(torch.tensor(v, dtype=torch.float32)).numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-6)
        # a Python number as the value, where the reference takes one
        if not isinstance(v, list):
            assert float(t.log_prob(v)) == pytest.approx(float(want), rel=1e-5, abs=1e-6) or (
                np.isneginf(want) and float(t.log_prob(v)) == -math.inf)
    assert t.batch_shape == tuple(j.batch_shape)


def test_xor_arguments_raise_as_the_reference():
    for make in (lambda m: m.Bernoulli(), lambda m: m.Bernoulli(probs=0.2, logits=0.0),
                 lambda m: m.Binomial(5), lambda m: m.MultivariateNormal([0.0, 0.0])):
        with pytest.raises(ValueError):
            make(ref)
        with pytest.raises(ValueError):
            make(port)


def test_log_prob_under_vmap_and_zero_gradients_at_the_edge():
    x = torch.tensor([0.5, 2.0, -1.0], requires_grad=True)
    for dist in (port.LogNormal(0.0, 1.0), port.Dirichlet([2.0, 3.0])):
        lp = torch.func.vmap(dist.log_prob)(
            x if dist.batch_shape == () else torch.stack([x, 1 - x], -1))
        assert torch.isneginf(lp[2])
        (g,) = torch.autograd.grad(lp[torch.isfinite(lp)].sum(), x)
        assert torch.isfinite(g).all() and float(g[2]) == 0.0
    assert torch.isneginf(torch.func.vmap(port.Uniform(0.0, 1.0).log_prob)(x.detach())[1:]).all()
    v = torch.tensor([[0.2, 0.3, 0.5], [0.1, 0.6, 0.3]])
    batched = torch.func.vmap(port.Dirichlet([2.0, 3.0, 4.0]).log_prob)(v)
    assert torch.allclose(batched, port.Dirichlet([2.0, 3.0, 4.0]).log_prob(v))
    mvn = port.MultivariateNormal(torch.zeros(2), covariance_matrix=[[2.0, 0.5], [0.5, 1.0]])
    pts = torch.tensor([[0.3, 0.2], [1.0, -1.0]])
    assert torch.allclose(torch.func.vmap(mvn.log_prob)(pts), mvn.log_prob(pts))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize(
    "dist,mean,var",
    [
        (port.Bernoulli(probs=0.3), 0.3, 0.21),
        (port.Uniform(1.0, 3.0), 2.0, 4.0 / 12),
        (port.LogNormal(0.0, 0.5), math.exp(0.125), None),
        (port.StudentT(5.0), 0.0, 5.0 / 3.0),
        (port.Poisson(4.0), 4.0, 4.0),
    ],
    ids=["bernoulli", "uniform", "lognormal", "studentt", "poisson"],
)
def test_moments(dist, mean, var):
    xs = dist.sample(_gen(3), (N,)).numpy()
    assert xs.shape == (N,)
    tol = 4 * math.sqrt((var if var else 1.0) / N) + 0.02
    assert abs(xs.mean() - mean) < tol
    if var is not None:
        assert np.isclose(xs.var(), var, rtol=0.2)


def test_dirichlet_simplex():
    xs = port.Dirichlet([2.0, 3.0, 4.0]).sample(_gen(0), (N,)).numpy()
    assert xs.shape == (N, 3)
    np.testing.assert_allclose(xs.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(xs.mean(axis=0), np.array([2, 3, 4]) / 9.0, atol=0.01)


def test_mvn_covariance():
    cov = np.array([[2.0, 0.8], [0.8, 1.0]])
    xs = port.MultivariateNormal(torch.zeros(2), covariance_matrix=cov).sample(_gen(1), (N,))
    np.testing.assert_allclose(np.cov(xs.numpy().T), cov, atol=0.1)


def test_sampling_moments_batch2():
    for dist in [port.Laplace(1.0, 2.0), port.Binomial(20, probs=0.3),
                 port.NegativeBinomial(5.0, 0.5)]:
        xs = dist.sample(_gen(11), (N,)).numpy()
        mean, var = float(dist.mean()), float(dist.variance())
        assert abs(xs.mean() - mean) < 4 * math.sqrt(var / N) + 0.02
        assert np.isclose(xs.var(), var, rtol=0.2)


def test_cauchy_sampling_median():
    xs = port.Cauchy(2.0, 1.0).sample(_gen(12), (N,)).numpy()
    assert abs(np.median(xs) - 2.0) < 0.1


def test_moments_match_the_reference():
    """mean() and variance() give the reference's values."""
    pairs = [
        (port.Bernoulli(probs=0.3), ref.Bernoulli(probs=0.3)),
        (port.Uniform(1.0, 3.0), ref.Uniform(1.0, 3.0)),
        (port.LogNormal(0.2, 0.5), ref.LogNormal(0.2, 0.5)),
        (port.StudentT(5.0, 1.0, 2.0), ref.StudentT(5.0, 1.0, 2.0)),
        (port.Poisson(4.0), ref.Poisson(4.0)),
        (port.Laplace(1.0, 2.0), ref.Laplace(1.0, 2.0)),
        (port.Binomial(20, probs=0.3), ref.Binomial(20, probs=0.3)),
        (port.NegativeBinomial(5.0, 0.5), ref.NegativeBinomial(5.0, 0.5)),
    ]
    for t, j in pairs:
        np.testing.assert_allclose(float(t.mean()), float(j.mean()), rtol=1e-6)
        np.testing.assert_allclose(float(t.variance()), float(j.variance()), rtol=1e-6)
