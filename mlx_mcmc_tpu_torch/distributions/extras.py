"""The distributions beyond the reference's six: Bernoulli, Uniform,
LogNormal, StudentT, Poisson, Dirichlet, MultivariateNormal, Laplace,
Cauchy, Binomial and NegativeBinomial.

Counterpart of ``mlx_mcmc_tpu/distributions/extras.py``, under the same
contract as the six: ``log_prob`` with broadcast parameters (Python numbers
or tensors), ``-inf`` outside the support with zero (not NaN) gradients at
its edge where the density is continuous, and ``sample(generator, shape)``
from an explicit ``torch.Generator``. Samples follow the same laws as the
reference's by other constructions (the generators differ, so draws agree
in distribution, not draw for draw): a Laplace variate is the difference of
two exponentials, a Student t a normal over the root of a scaled gamma, a
Dirichlet normalised gammas, a negative binomial a gamma-Poisson mixture.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from mlx_mcmc_tpu_torch.distributions.base import (
    Distribution,
    as_float,
    as_value,
    lgamma_param,
    log_param,
    param_shape,
)
from mlx_mcmc_tpu_torch.distributions.gamma import standard_gamma
from mlx_mcmc_tpu_torch.distributions.normal import _HALF_LOG_2PI
from mlx_mcmc_tpu_torch.ops.math import safe_where_log_prob

_LOG_PI = math.log(math.pi)


def _log1p_param(x):
    """``log1p`` of a parameter (a Python number through ``math``)."""
    if isinstance(x, (int, float)):
        return math.log1p(x) if x > -1 else (-math.inf if x == -1 else math.nan)
    return torch.log1p(x)


def _on(generator: torch.Generator, x, shape) -> torch.Tensor:
    """A parameter as a float32 tensor of ``shape`` on the generator's device."""
    return as_float(x).to(generator.device).expand(shape).contiguous()


def _logits(probs, logits) -> torch.Tensor:
    """Exactly one of ``probs`` and ``logits``, as float32 logits."""
    if (probs is None) == (logits is None):
        raise ValueError("Provide exactly one of `probs` or `logits`.")
    if logits is not None:
        return as_float(logits)
    p = as_float(probs)
    return torch.log(p) - torch.log1p(-p)


def _whole(value: torch.Tensor) -> torch.Tensor:
    return value == torch.floor(value)


class Bernoulli(Distribution):
    """Bernoulli over {0, 1}, parameterized by ``probs`` XOR ``logits``."""

    def __init__(self, probs=None, logits=None):
        self.logits = _logits(probs, logits)

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    @property
    def batch_shape(self):
        return tuple(self.logits.shape)

    def log_prob(self, value):
        value = as_value(value)
        # value * logit - softplus(logit), for value in {0, 1}
        lp = value * self.logits - F.softplus(self.logits)
        return torch.where((value == 0) | (value == 1), lp, -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        probs = _on(generator, self.probs, self._sample_shape(shape))
        return torch.bernoulli(probs, generator=generator)

    def mean(self):
        return self.probs

    def variance(self):
        p = self.probs
        return p * (1.0 - p)


class Uniform(Distribution):
    """Continuous uniform on ``[low, high]``."""

    def __init__(self, low=0.0, high=1.0):
        self.low = low
        self.high = high

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.low), param_shape(self.high)))

    def log_prob(self, value):
        value = as_value(value)
        in_support = (value >= self.low) & (value <= self.high)
        return torch.where(in_support, -as_float(log_param(self.high - self.low)), -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        u = torch.rand(self._sample_shape(shape), generator=generator, device=generator.device)
        return self.low + (self.high - self.low) * u

    def mean(self):
        return 0.5 * (as_float(self.low) + as_float(self.high))

    def variance(self):
        return (as_float(self.high) - as_float(self.low)) ** 2 / 12.0


class LogNormal(Distribution):
    """``exp(N(loc, scale))``; support (0, inf)."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.loc), param_shape(self.scale)))

    def log_prob(self, value):
        value = as_value(value)

        def _lp(x):
            lx = torch.log(x)
            z = (lx - self.loc) / self.scale
            return -0.5 * z * z - lx - log_param(self.scale) - _HALF_LOG_2PI

        return safe_where_log_prob(value > 0.0, value, 1.0, _lp)

    def sample(self, generator: torch.Generator, shape=()):
        eps = torch.randn(self._sample_shape(shape), generator=generator, device=generator.device)
        return torch.exp(self.loc + self.scale * eps)

    def mean(self):
        return torch.exp(as_float(self.loc) + 0.5 * as_float(self.scale) ** 2)

    def variance(self):
        s2 = as_float(self.scale) ** 2
        return (torch.exp(s2) - 1.0) * torch.exp(2.0 * as_float(self.loc) + s2)

    def median(self):
        return torch.exp(as_float(self.loc))


class StudentT(Distribution):
    """Student's t with ``df`` degrees of freedom, location and scale."""

    def __init__(self, df, loc=0.0, scale=1.0):
        self.df = df
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(
            param_shape(self.df), param_shape(self.loc), param_shape(self.scale)))

    def log_prob(self, value):
        df = self.df
        z = (as_value(value) - self.loc) / self.scale
        return (
            lgamma_param(0.5 * (df + 1.0))
            - lgamma_param(0.5 * df)
            - 0.5 * log_param(df * math.pi)
            - log_param(self.scale)
            - 0.5 * (df + 1.0) * torch.log1p(z * z / df)
        )

    def sample(self, generator: torch.Generator, shape=()):
        out_shape = self._sample_shape(shape)
        eps = torch.randn(out_shape, generator=generator, device=generator.device)
        chi2 = 2.0 * standard_gamma(0.5 * as_float(self.df), out_shape, generator)
        return self.loc + self.scale * eps * torch.rsqrt(chi2 / self.df)

    def mean(self):
        df = as_float(self.df)
        return torch.where(df > 1.0, as_float(self.loc).expand(self.batch_shape), math.nan)

    def variance(self):
        df = as_float(self.df)
        v = as_float(self.scale) ** 2 * df / (df - 2.0)
        return torch.where(df > 2.0, v, torch.where(df > 1.0, math.inf, math.nan))


class Poisson(Distribution):
    """Poisson with rate ``rate``; support {0, 1, 2, ...}."""

    def __init__(self, rate):
        self.rate = rate

    @property
    def batch_shape(self):
        return param_shape(self.rate)

    def log_prob(self, value):
        value = as_value(value)
        safe = torch.where(value >= 0, value, 0.0)
        lp = safe * log_param(self.rate) - self.rate - torch.lgamma(safe + 1.0)
        return torch.where((value >= 0) & _whole(value), lp, -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        rate = _on(generator, self.rate, self._sample_shape(shape))
        return torch.poisson(rate, generator=generator)

    def mean(self):
        return as_float(self.rate)

    def variance(self):
        return as_float(self.rate)


class Dirichlet(Distribution):
    """Dirichlet over the simplex; ``concentration`` has the category axis last."""

    def __init__(self, concentration):
        self.concentration = as_float(concentration)

    @property
    def batch_shape(self):
        return tuple(self.concentration.shape[:-1])

    def log_prob(self, value):
        value = as_value(value)
        a = self.concentration
        in_support = (value > 0.0).all(-1) & ((value.sum(-1) - 1.0).abs() < 1e-4)
        safe = torch.where(value > 0.0, value, 0.5)
        lp = (
            ((a - 1.0) * torch.log(safe)).sum(-1)
            - torch.lgamma(a).sum(-1)
            + torch.lgamma(a.sum(-1))
        )
        return torch.where(in_support, lp, -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        if isinstance(shape, int):
            shape = (shape,)
        g = standard_gamma(self.concentration, tuple(shape) + tuple(self.concentration.shape),
                           generator)
        return g / g.sum(-1, keepdim=True)

    def mean(self):
        a = self.concentration
        return a / a.sum(-1, keepdim=True)


class MultivariateNormal(Distribution):
    """Multivariate normal with a dense covariance, given as its Cholesky
    factor ``scale_tril`` or as ``covariance_matrix``."""

    def __init__(self, loc, covariance_matrix=None, scale_tril=None):
        if (covariance_matrix is None) == (scale_tril is None):
            raise ValueError("Provide exactly one of `covariance_matrix` or `scale_tril`.")
        self.loc = as_float(loc)
        if scale_tril is None:
            scale_tril = torch.linalg.cholesky(as_float(covariance_matrix))
        self.scale_tril = as_float(scale_tril)

    @property
    def dim(self):
        return self.loc.shape[-1]

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(self.loc.shape[:-1], self.scale_tril.shape[:-2]))

    def log_prob(self, value):
        diff = as_value(value) - self.loc
        L = self.scale_tril
        # L z = diff
        z = torch.linalg.solve_triangular(
            L.expand(diff.shape[:-1] + L.shape[-2:]), diff[..., None], upper=False)[..., 0]
        log_det = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
        return -0.5 * (z * z).sum(-1) - log_det - self.dim * _HALF_LOG_2PI

    def sample(self, generator: torch.Generator, shape=()):
        if isinstance(shape, int):
            shape = (shape,)
        out_shape = tuple(shape) + self.batch_shape + (self.dim,)
        eps = torch.randn(out_shape, generator=generator, device=generator.device)
        L = self.scale_tril.to(generator.device)
        return self.loc.to(generator.device) + torch.einsum("...ij,...j->...i", L, eps)

    def mean(self):
        return self.loc

    def covariance(self):
        return self.scale_tril @ self.scale_tril.transpose(-1, -2)


class Laplace(Distribution):
    """Laplace (double exponential) with location and scale."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.loc), param_shape(self.scale)))

    def log_prob(self, value):
        z = torch.abs(as_value(value) - self.loc) / self.scale
        return -z - log_param(2.0 * self.scale)

    def sample(self, generator: torch.Generator, shape=()):
        e = torch.empty((2,) + self._sample_shape(shape), device=generator.device)
        e.exponential_(1.0, generator=generator)
        return self.loc + self.scale * (e[0] - e[1])

    def mean(self):
        return as_float(self.loc).expand(self.batch_shape)

    def variance(self):
        return 2.0 * as_float(self.scale) ** 2


class Cauchy(Distribution):
    """Cauchy with location and scale (no mean or variance)."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = loc
        self.scale = scale

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.loc), param_shape(self.scale)))

    def log_prob(self, value):
        z = (as_value(value) - self.loc) / self.scale
        return -torch.log1p(z * z) - log_param(self.scale) - _LOG_PI

    def sample(self, generator: torch.Generator, shape=()):
        c = torch.empty(self._sample_shape(shape), device=generator.device)
        return self.loc + self.scale * c.cauchy_(generator=generator)

    def median(self):
        return as_float(self.loc).expand(self.batch_shape)


class Binomial(Distribution):
    """Binomial(total_count, probs XOR logits): support {0, ..., n}."""

    def __init__(self, total_count, probs=None, logits=None):
        self.total_count = total_count
        self.logits = _logits(probs, logits)

    @property
    def probs(self):
        return torch.sigmoid(self.logits)

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.total_count), self.logits.shape))

    def log_prob(self, value):
        value = as_value(value)
        n = self.total_count
        in_range = (value >= 0) & (value <= n)
        k = torch.where(in_range, value, 0.0)
        log_binom = lgamma_param(n + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(n - k + 1.0)
        lp = log_binom + k * self.logits - n * F.softplus(self.logits)
        return torch.where(in_range & _whole(value), lp, -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        out_shape = self._sample_shape(shape)
        return torch.binomial(_on(generator, self.total_count, out_shape),
                              _on(generator, self.probs, out_shape), generator=generator)

    def mean(self):
        return as_float(self.total_count) * self.probs

    def variance(self):
        p = self.probs
        return as_float(self.total_count) * p * (1 - p)


class NegativeBinomial(Distribution):
    """Negative binomial: failures before the ``total_count``-th success,
    with success probability ``probs`` (mean ``n (1 - p) / p``)."""

    def __init__(self, total_count, probs):
        self.total_count = total_count
        self.probs = probs

    @property
    def batch_shape(self):
        return tuple(torch.broadcast_shapes(param_shape(self.total_count),
                                            param_shape(self.probs)))

    def log_prob(self, value):
        value = as_value(value)
        n, p = self.total_count, self.probs
        k = torch.where(value >= 0, value, 0.0)
        lp = (
            torch.lgamma(k + n)
            - lgamma_param(n)
            - torch.lgamma(k + 1.0)
            + n * log_param(p)
            + k * _log1p_param(-p)
        )
        return torch.where((value >= 0) & _whole(value), lp, -math.inf)

    def sample(self, generator: torch.Generator, shape=()):
        # lambda ~ Gamma(n, rate p / (1 - p)), k ~ Poisson(lambda)
        out_shape = self._sample_shape(shape)
        p = _on(generator, self.probs, out_shape)
        lam = standard_gamma(self.total_count, out_shape, generator) * (1.0 - p) / p
        return torch.poisson(lam, generator=generator)

    def mean(self):
        n, p = as_float(self.total_count), as_float(self.probs)
        return n * (1 - p) / p

    def variance(self):
        n, p = as_float(self.total_count), as_float(self.probs)
        return n * (1 - p) / (p * p)
