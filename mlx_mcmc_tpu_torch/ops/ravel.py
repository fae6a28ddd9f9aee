"""Dict-of-params <-> flat float32 vector.

Counterpart of ``mlx_mcmc_tpu/ops/ravel.py``. Leaves are flattened in JAX's
order (``ravel_pytree`` sorts dict keys), so a flat vector here lines up
element for element with the reference's. Every leaf becomes float32:
integers and float64 numpy values included.

``unravel`` keeps leading batch axes: a ``(C, S, D)`` tensor of draws comes
back as a dict of ``(C, S, *shape)`` tensors.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, Tuple

import torch


def _leaves(params: Any, prefix=()) -> List[Tuple[tuple, Any]]:
    if isinstance(params, dict):
        out = []
        for k in sorted(params):
            out.extend(_leaves(params[k], prefix + (k,)))
        return out
    return [(prefix, params)]


def ravel_params(
    params: Any, device=None
) -> Tuple[torch.Tensor, Callable[[torch.Tensor], Any]]:
    """Flatten a (possibly nested) dict of array-likes into one f32 vector.

    Returns ``(flat, unravel)``; ``unravel(flat)`` rebuilds the dict.
    """
    leaves = [
        (path, torch.as_tensor(v, dtype=torch.float32, device=device))
        for path, v in _leaves(params)
    ]
    shapes = [(path, tuple(t.shape)) for path, t in leaves]
    flat = torch.cat([t.reshape(-1) for _, t in leaves]) if leaves else (
        torch.zeros((0,), dtype=torch.float32, device=device)
    )

    def unravel(z: torch.Tensor) -> Any:
        batch = tuple(z.shape[:-1])
        out: dict = {}
        offset = 0
        for path, shape in shapes:
            n = math.prod(shape)
            leaf = z[..., offset:offset + n].reshape(batch + shape)
            offset += n
            if not path:
                return leaf
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = leaf
        return out

    return flat, unravel


def ravel_batched(params: Any, device=None) -> torch.Tensor:
    """Flatten a dict whose leaves share a leading batch axis ``B`` into one
    ``(B, D)`` float32 tensor, each row laid out as :func:`ravel_params`
    lays out one entry."""
    leaves = [torch.as_tensor(v, dtype=torch.float32, device=device) for _, v in _leaves(params)]
    return torch.cat([t.reshape(t.shape[0], -1) for t in leaves], dim=1).contiguous()


def make_flat_logprob(
    log_prob_fn: Callable[..., torch.Tensor],
    example_params: Any,
    data_aware: bool = False,
    device=None,
):
    """Wrap a dict-of-params log-prob into a flat-vector one.

    Returns ``(flat_log_prob, initial_flat, unravel)``. A NaN log-density
    becomes ``-inf`` so accept/reject logic never sticks on a NaN state.
    With ``data_aware=True`` the model is ``log_prob_fn(params, data)`` and
    the wrapper is ``flat_log_prob(z, data)``. The wrapper carries the
    model's ``graph_safe`` (False where the model has none): whether CUDA
    graphs may capture it (``inference/graphs.py``).
    """
    initial_flat, unravel = ravel_params(example_params, device=device)

    def _sanitize(out):
        out = torch.as_tensor(out).reshape(())
        return torch.where(torch.isnan(out), -math.inf, out)

    if data_aware:

        def flat_log_prob(z: torch.Tensor, data) -> torch.Tensor:
            return _sanitize(log_prob_fn(unravel(z), data))

    else:

        def flat_log_prob(z: torch.Tensor) -> torch.Tensor:
            return _sanitize(log_prob_fn(unravel(z)))

    flat_log_prob.graph_safe = bool(getattr(log_prob_fn, "graph_safe", False))
    return flat_log_prob, initial_flat, unravel
