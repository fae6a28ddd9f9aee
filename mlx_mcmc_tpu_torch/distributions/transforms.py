"""Unconstraining bijectors for constrained parameters.

Counterpart of ``mlx_mcmc_tpu/distributions/transforms.py``, with its
names. Each transform maps *unconstrained -> constrained*:

    y = forward(x),  x = inverse(y),  log|dy/dx| = log_det_jacobian(x)

``make_transformed_logprob`` rewrites a dict-of-params model so that the
parameters it names are sampled in unconstrained space, with the
log-|Jacobian| added. Every map is elementwise or over the last axis, so
leading batch axes (chains, draws) pass through.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from mlx_mcmc_tpu_torch.distributions.base import as_float


class Transform:
    def forward(self, x):
        raise NotImplementedError

    def inverse(self, y):
        raise NotImplementedError

    def log_det_jacobian(self, x):
        """log |d forward(x) / dx|, summed over the parameter's elements."""
        raise NotImplementedError


class Identity(Transform):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y

    def log_det_jacobian(self, x):
        return x.new_zeros(())


class Exp(Transform):
    """R -> (0, inf): for scales, rates and other positive parameters."""

    def forward(self, x):
        return torch.exp(x)

    def inverse(self, y):
        return torch.log(y)

    def log_det_jacobian(self, x):
        return torch.sum(x)


class Softplus(Transform):
    """R -> (0, inf) with linear tails (better conditioned than Exp for
    large positive values)."""

    def forward(self, x):
        return F.softplus(x)

    def inverse(self, y):
        return y + torch.log(-torch.expm1(-y))

    def log_det_jacobian(self, x):
        return torch.sum(-F.softplus(-x))


class Sigmoid(Transform):
    """R -> (0, 1): for probabilities (Beta-distributed parameters)."""

    def forward(self, x):
        return torch.sigmoid(x)

    def inverse(self, y):
        return torch.log(y) - torch.log1p(-y)

    def log_det_jacobian(self, x):
        return torch.sum(-F.softplus(-x) - F.softplus(x))


def _stick_offset(x: torch.Tensor, k: int) -> torch.Tensor:
    return torch.log(torch.arange(k, 0, -1, dtype=x.dtype, device=x.device))


class StickBreaking(Transform):
    """R^{K-1} -> interior of the K-simplex (Stan's stick-breaking map)."""

    def forward(self, x):
        z = torch.sigmoid(x - _stick_offset(x, x.shape[-1]))
        cum = torch.cat([torch.ones_like(x[..., :1]), torch.cumprod(1.0 - z, dim=-1)], dim=-1)
        return torch.cat([cum[..., :-1] * z, cum[..., -1:]], dim=-1)

    def inverse(self, y):
        k = y.shape[-1] - 1
        rem = 1.0 - torch.cat([torch.zeros_like(y[..., :1]), torch.cumsum(y[..., :-1], -1)],
                              dim=-1)[..., :-1]
        z = y[..., :-1] / rem
        return torch.log(z) - torch.log1p(-z) + _stick_offset(y, k)

    def log_det_jacobian(self, x):
        xs = x - _stick_offset(x, x.shape[-1])
        z = torch.sigmoid(xs)
        log_sigmoid_det = -F.softplus(-xs) - F.softplus(xs)
        cumlog1mz = torch.cat(
            [torch.zeros_like(x[..., :1]), torch.cumsum(torch.log1p(-z[..., :-1]), dim=-1)],
            dim=-1)
        return torch.sum(log_sigmoid_det + cumlog1mz)


_NAMED: Dict[str, Callable[[], Transform]] = {
    "identity": Identity,
    "exp": Exp,
    "log": Exp,  # alias: parameter constrained positive, sampled as its log
    "softplus": Softplus,
    "sigmoid": Sigmoid,
    "logit": Sigmoid,
    "simplex": StickBreaking,
}


def get_transform(t) -> Transform:
    """A ``Transform`` instance as it is, or the one a name gives."""
    if isinstance(t, Transform):
        return t
    return _NAMED[t]()


def make_transformed_logprob(
    log_prob_fn: Callable[..., torch.Tensor],
    transforms: Dict[str, Any],
    data_aware: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """Rewrite a dict-of-params model to sample in unconstrained space.

    Returns ``(u_log_prob, to_constrained, to_unconstrained)`` where
    ``u_log_prob(u_params) = log_prob(constrain(u_params)) + log|J|``.
    Parameters not named in ``transforms`` pass through unchanged.
    With ``data_aware=True`` the model (and the returned ``u_log_prob``)
    additionally take a ``data`` argument. ``u_log_prob`` carries the
    model's ``graph_safe`` (``inference/graphs.py``): the transforms add
    nothing that a capture forbids.
    """
    tfs = {k: get_transform(v) for k, v in transforms.items()}

    def to_constrained(u_params):
        return {k: (tfs[k].forward(v) if k in tfs else v) for k, v in u_params.items()}

    def to_unconstrained(params):
        return {k: (tfs[k].inverse(as_float(v)) if k in tfs else v) for k, v in params.items()}

    def _jacobian(u_params):
        lp = 0.0
        for k, tf in tfs.items():
            lp = lp + tf.log_det_jacobian(u_params[k])
        return lp

    if data_aware:

        def u_log_prob(u_params, data):
            return log_prob_fn(to_constrained(u_params), data) + _jacobian(u_params)

    else:

        def u_log_prob(u_params):
            return log_prob_fn(to_constrained(u_params)) + _jacobian(u_params)

    u_log_prob.graph_safe = bool(getattr(log_prob_fn, "graph_safe", False))
    return u_log_prob, to_constrained, to_unconstrained
