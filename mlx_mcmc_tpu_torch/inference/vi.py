"""ADVI: automatic differentiation variational inference.

Counterpart of ``mlx_mcmc_tpu/inference/vi.py``. A Gaussian ``q`` over the
flat unconstrained parameter vector, mean-field

    q(z) = N(mu, diag(exp(log_sigma)^2))

or full-rank, ``N(mu, L L^T)`` with ``L`` lower-triangular (a softplus
diagonal and the packed lower triangle, as the reference's ``build_L``),
is fitted by Adam (``ops.math.adam_update``) on reparameterized estimates
of the negative ELBO from ``num_mc_samples`` draws a step. The draws' log
density and its gradient come from one batched value+grad call
(:func:`batched_density`): a fused ``value_and_grad_fn`` where one is
given (K1, K3 on the card), else autograd of the model under
``torch.func.vmap``. The reparameterization gradient needs only grad log p
at the draws.

Estimator: "sticking the landing" (Roeder et al., 2017): log q is scored
at detached variational parameters, so only the path derivative flows and
its variance vanishes at the optimum. Non-finite gradients (a draw outside
a constrained model's support) count as 0. The reference's fit is one
compiled scan; here the steps run eagerly, and none reads the host: the
ELBO trace is written on the device.

Two uses: ``fit_advi(log_prob, initial_params) -> ADVIResult``, and
``sample(..., init_strategy='advi')``, which draws the chains' starts from
a fitted mean-field q and takes q's variances as the initial inverse mass
diagonal (:func:`advi_initialize`).

Random draws come from Philox (``ops/random.step_draws``) at rows that no
sampling run draws from. A run's chains are global indices below 2^31 (the
Philox kernel takes fewer than 2^31 values a call), and its steps, the
step-size probe (``engine._PROBE_STEP``), the jitter (``engine.JITTER_STEP``)
and the MAP init's jitter (``init_strategies.MAP_JITTER_STEP``) all draw
there. A fit's normals at step ``t`` come from rows :data:`FIT_ROW` ``+ m``
(``m < num_mc_samples``), draws from ``q`` from rows :data:`DRAW_ROW` ``+ i``
at :data:`INIT_DRAW_STEP` (the chains' starts) or
:data:`POSTERIOR_DRAW_STEP` (``sample_posterior``): disjoint from every
sampling draw and from each other, whatever the step count. The reference
draws from its own threefry keys, so fits agree statistically, not draw for
draw.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.diagnostics.stats import summary_stats
from mlx_mcmc_tpu_torch.distributions.transforms import make_transformed_logprob
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.ops.math import adam_update
from mlx_mcmc_tpu_torch.ops.random import step_draws
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

_LOG_2PI = float(np.log(2.0 * np.pi))

FIT_ROW = 0x80000000  # rows of a fit's Monte Carlo normals
DRAW_ROW = 0xC0000000  # rows of the draws from q
INIT_DRAW_STEP = 0
POSTERIOR_DRAW_STEP = 1


def _normals(seed: int, row: int, step: int, n: int, dim: int, device) -> torch.Tensor:
    """``(n, dim)`` standard normals from Philox at rows ``row + i``."""
    rows = row + torch.arange(n, device=device)
    return step_draws(seed, rows, step, dim, 0)[0]


class _Density(torch.autograd.Function):
    """log p over ``(M, D)`` draws from a batched value+grad: its value
    forward, its gradient times the incoming one backward."""

    @staticmethod
    def forward(ctx, z, vag):
        value, grad = vag(z)
        ctx.save_for_backward(grad)
        return value

    @staticmethod
    def backward(ctx, grad_out):
        (grad,) = ctx.saved_tensors
        return grad_out[:, None] * grad, None


def batched_vag(flat_log_prob: Optional[Callable], data=None,
                value_and_grad_fn: Optional[Callable] = None) -> Callable:
    """``vag(Z (M, D)) -> (value (M,), grad (M, D))``: ``value_and_grad_fn(Z)``
    (or ``(Z, data)``) where given, else autograd of ``flat_log_prob``."""
    if value_and_grad_fn is None:
        return make_batched_value_and_grad(flat_log_prob, data)
    if data is None:
        return value_and_grad_fn

    def vag(Z):
        return value_and_grad_fn(Z, data)

    return vag


def batched_density(vag: Callable) -> Callable:
    """``log_prob_batched(z (M, D)) -> (M,)``, differentiable in ``z``,
    through one call of the batched value+grad ``vag``."""
    return lambda z: _Density.apply(z, vag)


def meanfield_neg_elbo(log_prob_batched: Callable, mu, log_sigma, eps) -> torch.Tensor:
    """The mean-field negative ELBO estimate from the ``(M, D)`` normals
    ``eps``, log q scored at detached ``mu`` and ``log_sigma``."""
    z = mu + torch.exp(log_sigma) * eps
    logp = log_prob_batched(z)
    mu_s, ls_s = mu.detach(), log_sigma.detach()
    logq = torch.sum(-0.5 * ((z - mu_s) * torch.exp(-ls_s)) ** 2 - ls_s - 0.5 * _LOG_2PI, dim=-1)
    return -torch.mean(logp - logq)


def build_L(raw_diag: torch.Tensor, raw_off: torch.Tensor) -> torch.Tensor:
    """The full-rank factor: the packed lower triangle ``raw_off`` (row by
    row, diagonal slots included, as ``jnp.tril_indices`` packs it) with its
    diagonal replaced by ``softplus(raw_diag)``."""
    dim = raw_diag.shape[0]
    rows, cols = torch.tril_indices(dim, dim, device=raw_diag.device)
    L = torch.zeros((dim, dim), dtype=raw_diag.dtype, device=raw_diag.device)
    L = L.index_put((rows, cols), raw_off)
    diag = torch.arange(dim, device=raw_diag.device)
    # jax.nn.softplus is logaddexp(x, 0)
    return L.index_put((diag, diag), torch.logaddexp(raw_diag, torch.zeros_like(raw_diag)))


def fullrank_neg_elbo(log_prob_batched: Callable, mu, raw_diag, raw_off, eps) -> torch.Tensor:
    """The full-rank negative ELBO estimate from the ``(M, D)`` normals
    ``eps``, log q scored at detached ``mu`` and ``L``."""
    L = build_L(raw_diag, raw_off)
    z = mu + eps @ L.T
    logp = log_prob_batched(z)
    mu_s, L_s = mu.detach(), L.detach()
    y = torch.linalg.solve_triangular(L_s, (z - mu_s).T, upper=False).T
    logq = (-0.5 * torch.sum(y**2, dim=-1) - torch.sum(torch.log(torch.diagonal(L_s)))
            - 0.5 * mu.shape[0] * _LOG_2PI)
    return -torch.mean(logp - logq)


def _fit(neg_elbo: Callable, params0: tuple, seed: int, num_steps: int, num_mc_samples: int,
         learning_rate: float):
    """Adam on ``neg_elbo(*params, eps)`` for ``num_steps`` steps, step
    ``t``'s normals from Philox at rows ``FIT_ROW + m``, step ``t``. Returns
    the final parameters and the ELBO trace, on the device."""
    params = params0
    m = v = tuple(torch.zeros_like(p) for p in params)
    dim, device = params[0].shape[0], params[0].device
    elbo = torch.empty((num_steps,), dtype=torch.float32, device=device)
    for t in range(num_steps):
        eps = _normals(seed, FIT_ROW, t, num_mc_samples, dim, device)
        with torch.enable_grad():
            leaves = tuple(p.detach().requires_grad_(True) for p in params)
            loss = neg_elbo(*leaves, eps)
            grads = torch.autograd.grad(loss, leaves)
        elbo[t] = -loss.detach()
        params, m, v = adam_update(params, grads, m, v, t + 1, learning_rate)
    return params, elbo


def fit_advi_flat(
    flat_log_prob: Callable[..., torch.Tensor],
    z0: torch.Tensor,
    seed: int,
    *,
    num_steps: int = 1000,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    init_log_sigma: float = -1.0,
    data=None,
    value_and_grad_fn: Optional[Callable] = None,
):
    """Fit a mean-field Gaussian to a flat log density from ``mu = z0``,
    ``log_sigma = init_log_sigma``; ``value_and_grad_fn`` (batched, as
    :func:`sample`'s) replaces autograd of ``flat_log_prob``, which may then
    be None. Returns ``(mu, log_sigma, elbo_trace)``, on ``z0``'s device."""
    mu0 = torch.as_tensor(z0, dtype=torch.float32).detach().clone()
    log_sigma0 = torch.full_like(mu0, init_log_sigma)
    lp = batched_density(batched_vag(flat_log_prob, data, value_and_grad_fn))
    (mu, log_sigma), elbo = _fit(
        lambda mu, ls, eps: meanfield_neg_elbo(lp, mu, ls, eps), (mu0, log_sigma0), seed,
        num_steps, num_mc_samples, learning_rate)
    return mu, log_sigma, elbo


def fit_advi_fullrank_flat(
    flat_log_prob: Callable[..., torch.Tensor],
    z0: torch.Tensor,
    seed: int,
    *,
    num_steps: int = 1000,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    init_log_sigma: float = -1.0,
    data=None,
    value_and_grad_fn: Optional[Callable] = None,
):
    """Full-rank Gaussian ADVI, ``q = N(mu, L L^T)``: captures the
    correlations that mean-field shrinks away (marginal variances as
    ``1 - rho^2``), at D (D + 1) / 2 more parameters and a triangular solve
    a step; ``value_and_grad_fn`` as in :func:`fit_advi_flat`. Returns
    ``(mu, scale_tril, elbo_trace)``."""
    mu0 = torch.as_tensor(z0, dtype=torch.float32).detach().clone()
    dim = mu0.shape[0]
    raw_diag0 = torch.full_like(mu0, float(np.log(np.expm1(np.exp(init_log_sigma)))))
    # the packed lower triangle with its diagonal slots, which build_L replaces
    raw_off0 = torch.zeros((dim * (dim + 1)) // 2, dtype=torch.float32, device=mu0.device)
    lp = batched_density(batched_vag(flat_log_prob, data, value_and_grad_fn))
    (mu, raw_diag, raw_off), elbo = _fit(
        lambda mu, rd, ro, eps: fullrank_neg_elbo(lp, mu, rd, ro, eps),
        (mu0, raw_diag0, raw_off0), seed, num_steps, num_mc_samples, learning_rate)
    return mu, build_L(raw_diag, raw_off), elbo


@dataclass
class ADVIResult:
    """A fitted Gaussian approximation (mean-field or full-rank).

    ``mu`` is q's mean over the flat, unconstrained vector. Mean-field fits
    carry ``log_sigma``; full-rank fits carry ``scale_tril`` (the Cholesky
    factor of q's covariance) and, as ``log_sigma``, the log of its row
    norms (q's marginal sd). ``sample_posterior`` maps draws back to the
    model's dict of (constrained) parameters.
    """

    mu: torch.Tensor
    log_sigma: torch.Tensor
    elbo_trace: torch.Tensor
    _unravel: Callable[[torch.Tensor], Any] = field(repr=False)
    _to_constrained: Optional[Callable[[Any], Any]] = field(default=None, repr=False)
    scale_tril: Optional[torch.Tensor] = None

    @property
    def elbo(self) -> float:
        """The last step's ELBO estimate."""
        return float(self.elbo_trace[-1])

    def sample_posterior(self, seed: int = 0, num_samples: int = 1000) -> Dict[str, Any]:
        """``num_samples`` draws from q as the model's parameter dict
        (constrained where the fit used transforms), leaves ``(num_samples,
        *shape)``."""
        eps = _normals(seed, DRAW_ROW, POSTERIOR_DRAW_STEP, num_samples, self.mu.shape[0],
                       self.mu.device)
        if self.scale_tril is not None:
            z = self.mu + eps @ self.scale_tril.T
        else:
            z = self.mu + torch.exp(self.log_sigma) * eps
        samples = self._unravel(z)
        return samples if self._to_constrained is None else self._to_constrained(samples)

    def posterior_mean(self) -> Dict[str, Any]:
        """q's mean through unravel (for transformed parameters the
        push-forward of the unconstrained mean: their median, not their
        mean)."""
        mean = self._unravel(self.mu)
        return mean if self._to_constrained is None else self._to_constrained(mean)

    def summary(self, seed: int = 0, num_samples: int = 4000) -> Dict[str, Dict[str, float]]:
        """Moments of q by Monte Carlo, with the MCMC summary's keys."""
        out: Dict[str, Dict[str, float]] = {}
        for k, v in self.sample_posterior(seed, num_samples).items():
            arr = v.detach().float().cpu().numpy()[None, ...]  # one "chain"
            if arr.ndim == 2:
                out[k] = summary_stats(arr, 0.95)
            else:
                flat_event = arr.reshape(1, arr.shape[1], -1)
                for i in range(flat_event.shape[-1]):
                    out[f"{k}[{i}]"] = summary_stats(flat_event[..., i], 0.95)
        return out


def fit_advi(
    log_prob_fn: Callable[..., torch.Tensor],
    initial_params: Any,
    *,
    method: str = "meanfield",
    num_steps: int = 1000,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    seed: int = 0,
    data=None,
    transforms: Optional[dict] = None,
    device=None,
) -> ADVIResult:
    """Fit ADVI to a dict-of-params model, with :func:`sample`'s model
    contract: ``log_prob_fn(params)`` (or ``(params, data)`` with
    ``data=``) and unconstraining ``transforms`` (q lives in unconstrained
    space; draws come back constrained).

    ``method``: 'meanfield' (diagonal q) or 'fullrank' (dense covariance by
    its Cholesky factor, exact on Gaussian targets). ``device=None`` means
    CUDA and raises without a GPU; pass ``'cpu'`` for the CPU.
    """
    if method not in ("meanfield", "fullrank"):
        raise ValueError(f"Unknown ADVI method: {method!r}")
    if not isinstance(seed, (int, np.integer)):
        raise TypeError(f"seed must be an int, got {type(seed).__name__}")
    dev = resolve_device(device)
    to_constrained = None
    if transforms:
        log_prob_fn, to_constrained, to_unconstrained = make_transformed_logprob(
            log_prob_fn, transforms, data_aware=data is not None)
        initial_params = to_unconstrained(initial_params)
    flat_log_prob, z0, unravel = make_flat_logprob(
        log_prob_fn, initial_params, data_aware=data is not None, device=dev)
    fit_kwargs = dict(num_steps=num_steps, num_mc_samples=num_mc_samples,
                      learning_rate=learning_rate, data=data)
    scale_tril = None
    if method == "fullrank":
        mu, scale_tril, elbo = fit_advi_fullrank_flat(flat_log_prob, z0, int(seed), **fit_kwargs)
        # q's marginal sd: the row norms of L
        log_sigma = 0.5 * torch.log(torch.sum(scale_tril**2, dim=1))
    else:
        mu, log_sigma, elbo = fit_advi_flat(flat_log_prob, z0, int(seed), **fit_kwargs)
    return ADVIResult(mu=mu, log_sigma=log_sigma, elbo_trace=elbo, _unravel=unravel,
                      _to_constrained=to_constrained, scale_tril=scale_tril)


def advi_initialize(
    flat_log_prob: Optional[Callable[..., torch.Tensor]],
    z0_batch: torch.Tensor,
    seed: int,
    *,
    num_steps: int = 500,
    num_mc_samples: int = 8,
    learning_rate: float = 0.05,
    data=None,
    value_and_grad_fn: Optional[Callable] = None,
):
    """``sample(..., init_strategy='advi')``'s warm start: fit a mean-field
    q from the first chain's start, then return ``(z0_batch',
    inv_mass_diag)``: each chain's start drawn from q (Philox at rows
    ``DRAW_ROW + chain``), except that a chain whose draw has a non-finite
    log density keeps its start, and q's variances. The fit and the check
    of the starts go through ``value_and_grad_fn`` (batched, as
    :func:`sample`'s: one call a step at ``num_mc_samples`` rows, one at
    every chain) where given, else through autograd of ``flat_log_prob``.
    Reads nothing on the host."""
    vag = batched_vag(flat_log_prob, data, value_and_grad_fn)
    mu, log_sigma, _ = fit_advi_flat(
        None, z0_batch[0], seed, num_steps=num_steps, num_mc_samples=num_mc_samples,
        learning_rate=learning_rate, value_and_grad_fn=vag)
    eps = _normals(seed, DRAW_ROW, INIT_DRAW_STEP, z0_batch.shape[0], z0_batch.shape[1],
                   z0_batch.device)
    starts = mu + torch.exp(log_sigma) * eps
    lp, _ = vag(starts)
    z0_new = torch.where(torch.isfinite(lp)[:, None], starts, z0_batch)
    return z0_new, torch.exp(2.0 * log_sigma)
