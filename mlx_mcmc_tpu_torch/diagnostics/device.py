"""Split R-hat and ESS on the device, with ``torch.fft``.

Counterpart of ``mlx_mcmc_tpu/diagnostics/device.py``. Only the thin
``(P,)`` statistics need to leave the card. ``device_ess_chunked`` slices
the parameter axis so the FFT intermediate stays bounded, and upcasts a bf16
draw store one slice at a time.

With ``group`` (a process group, or a ``parallel.distributed.Collectives``
that counts what it runs) the chains are sharded over its ranks, each rank
holding the same number, and the chain statistics are pooled with the
reference's formulas (its ``axis_name`` path): means of within-chain
variance, grand mean, between-chain variance and autocovariance across the
ranks, ``m`` counting every rank's chains. Only ``(P,)`` statistics cross
ranks. ``group=None`` is the single-device computation, and a world of one
gives its bits.
"""

from __future__ import annotations

import torch


def _pooling(group):
    """``(pmean, world size)`` over ``group``; the identity and 1 for None."""
    if group is None:
        return (lambda x: x), 1
    from mlx_mcmc_tpu_torch.parallel.distributed import Collectives

    pool = group if isinstance(group, Collectives) else Collectives(group)
    return pool.pmean, pool.world


def device_rhat(x: torch.Tensor, group=None) -> torch.Tensor:
    """Split R-hat. ``x``: (chains, draws, ...) -> shape ``(...)``."""
    pmean, world = _pooling(group)
    c, n = x.shape[0], x.shape[1]
    half = n // 2
    x = torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)
    m, n = 2 * c * world, half

    chain_means = x.mean(dim=1)
    chain_vars = x.var(dim=1, correction=1)
    within = pmean(chain_vars.mean(dim=0))
    grand_mean = pmean(chain_means.mean(dim=0))
    sq = pmean(((chain_means - grand_mean) ** 2).mean(dim=0))
    between = sq * m / max(m - 1, 1) * n
    var_plus = (n - 1) / n * within + between / n
    return torch.sqrt(var_plus / within)


def device_ess(x: torch.Tensor, group=None) -> torch.Tensor:
    """Combined-chain ESS. ``x``: (chains, draws, ...) -> ``(...)``.

    Geyer truncation without data-dependent control flow: pair sums, a
    cumulative-product positivity mask and a ``cummin`` monotone pass.
    """
    pmean, world = _pooling(group)
    m, n = x.shape[0] * world, x.shape[1]
    centered = x - x.mean(dim=1, keepdim=True)
    pad = 1 << (2 * n - 1).bit_length()
    f = torch.fft.rfft(centered, n=pad, dim=1)
    acov = torch.fft.irfft(f * f.conj(), n=pad, dim=1)[:, :n] / n

    chain_var = acov[:, 0] * n / (n - 1.0)
    mean_var = pmean(chain_var.mean(dim=0))  # W
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        chain_means = x.mean(dim=1)
        sq = ((chain_means - pmean(chain_means.mean(dim=0))) ** 2).mean(dim=0)
        var_plus = var_plus + pmean(sq) * m / (m - 1.0)

    rho = 1.0 - (mean_var[None] - pmean(acov.mean(dim=0))) / var_plus[None]
    rho[0] = 1.0

    max_pairs = n // 2
    pair = rho[: 2 * max_pairs].reshape((max_pairs, 2) + tuple(rho.shape[1:])).sum(dim=1)
    keep = (pair > 0.0).to(torch.int32).cumprod(dim=0).bool()
    pair = torch.where(keep, pair, 0.0)
    pair = torch.cummin(pair, dim=0).values
    pair = torch.clamp(pair, min=0.0)
    tau = -1.0 + 2.0 * pair.sum(dim=0)
    ess = m * n / torch.clamp(tau, min=1e-12)
    cap = m * n * torch.log10(torch.tensor(max(float(m * n), 10.0)))
    return torch.clamp(ess, max=float(cap))


def device_ess_chunked(x: torch.Tensor, max_bytes: float = 5e8, group=None) -> torch.Tensor:
    """ESS of every parameter of a (chains, draws, P) store, ``(P,)`` f32.

    Slices P so the (chains, pad, width) complex FFT intermediate stays near
    ``max_bytes``; each slice is upcast to f32 on its own, so a bf16 store
    never has a full f32 copy. ``group``: as :func:`device_ess` (every rank
    cuts the same slices: the same chains a rank).
    """
    c, n, p = x.shape
    pad = 1 << (2 * n - 1).bit_length()
    width = max(1, int(max_bytes / (c * pad * 8)))
    return torch.cat(
        [device_ess(x[..., i:i + width].float(), group) for i in range(0, p, width)]
    )
