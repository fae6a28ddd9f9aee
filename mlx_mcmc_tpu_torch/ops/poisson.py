"""Fused hierarchical Poisson regression log-likelihood + gradient.

Counterpart of ``mlx_mcmc_tpu/ops/pallas/poisson.py``. For counts
``y_gi ~ Poisson(exp(theta_g + x_gi . beta))`` and chain positions in the
flat order ``[beta (K), log_tau, mu, theta_raw (G)]`` (the sorted ravel of
the model's parameters), with ``theta = mu + tau theta_raw``:

    s     = theta_g + x_gi . beta          exact float32 (never bf16/TF32)
    ll    = sum_gi y (s - shat_g) - (exp(s) - lamhat_g)   + c0
    dll/dtheta_g = sum_i (y - exp(s)),   dll/dbeta = sum_gi (y - exp(s)) x_gi

The per-row terms are centered on each group's baseline rate
``lamhat_g = max(mean(y_g), 1e-3)`` (``shat_g = log lamhat_g``) and the
constant ``c0 = -sum log y! + sum (y shat - lamhat)`` is added once, so the
float32 sums stay small: at 100K counts the uncentered sum carried nats of
order-dependent rounding, which collapsed adaptation in the reference.

``fused_poisson_vag_cuda`` launches the hand-written Hopper kernel
``csrc/poisson_fused.cu``; ``fused_poisson_vag_reference`` is its plain
PyTorch version (the same float32 function). ``fused_poisson_value_and_grad``
takes the plain version only for CPU tensors; for CUDA tensors it launches
the kernel or raises. The reference's ``[X | E]`` augmentation and its
128-row group padding are TPU layout choices and are not kept: the data are
``X (G, n, K)`` and ``y (G, n)`` as they come (``convert.py`` strips them
from the reference's pytree).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mlx_mcmc_tpu_torch import _build, _capture
from mlx_mcmc_tpu_torch._device import resolve_device, sm_count
from mlx_mcmc_tpu_torch.ops.math import row_sum
from mlx_mcmc_tpu_torch.ops.ravel import ravel_params

_CHAIN_TILE = 256  # chains per block (kChains)
_MAX_GROUPS = 16  # groups per block at most (kMaxGroups)
_MAX_CHUNK_ROWS = 1024  # rows of a slab staged at a time (kMaxChunkRows)
_MAX_K = 8  # kMaxK
_SPLITS_PER_SM = 1  # group splits per SM the slab size aims at (1, 2, 4 measured on an H100)


def prepare_fused_poisson_data(y, X, device=None) -> dict:
    """Pack ``(G, n)`` counts and ``(G, n, K)`` covariates for
    :func:`make_fused_poisson_vag`: float32 ``X`` and ``y``, the per-group
    centering rates ``shat`` and ``lamhat`` (G,), and ``c0`` (summed in
    float64 from the same float32 centering rates)."""
    dev = resolve_device(device)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev).contiguous()
    X = torch.as_tensor(X, dtype=torch.float32, device=dev).contiguous()
    if y.dim() != 2 or X.dim() != 3 or tuple(X.shape[:2]) != tuple(y.shape):
        raise ValueError(f"expected y (G, n) and X (G, n, K), got {tuple(y.shape)}, {tuple(X.shape)}")
    lamhat = torch.clamp(y.mean(dim=1), min=1e-3)
    shat = torch.log(lamhat)
    y64 = y.double()
    c0 = -torch.lgamma(y64 + 1.0) + y64 * shat.double()[:, None] - lamhat.double()[:, None]
    return {
        "X": X,
        "y": y,
        "shat": shat,
        "lamhat": lamhat,
        "c0": float(c0.sum()),
        "G": y.shape[0],
        "K": X.shape[2],
    }


def fused_poisson_vag_reference(X, y, shat, lamhat, theta, beta):
    """Plain PyTorch version of the kernel, on any device: for ``theta
    (C, G)`` and ``beta (C, K)``, the centered ``ll (C,)`` (without ``c0``),
    ``r_theta (C, G)`` and ``g_beta (C, K)``, all in float32."""
    G, n, K = X.shape
    Xf = X.reshape(G * n, K)
    s = theta[:, :, None] + (beta @ Xf.T).view(-1, G, n)
    lam = torch.exp(s)
    r = y - lam
    ll = (y * (s - shat[:, None]) - (lam - lamhat[:, None])).sum(dim=(1, 2))
    return ll, r.sum(dim=-1), r.reshape(-1, G * n) @ Xf


def _groups_per_block(G: int, n: int, sms: int) -> int:
    """Groups in one block's slab, from the data's shape and the SM count
    only (never the chain count, so a chain's sums are taken in the same
    order whatever C is): about ``_SPLITS_PER_SM`` split per SM, a slab
    of at most ``_MAX_CHUNK_ROWS`` rows where groups are that short, at
    most ``_MAX_GROUPS`` groups, and at most 65535 splits."""
    gpb = min(-(-G // (_SPLITS_PER_SM * sms)), max(1, _MAX_CHUNK_ROWS // n), _MAX_GROUPS)
    return max(1, gpb, -(-G // 65535))


def launch_plan(G: int, n: int, C: int, sms: int) -> dict:
    """The kernel's grid for G groups of n counts and C chains on ``sms``
    SMs: ``groups_per_block`` and ``splits`` (the blocks along the groups)
    depend on G, n and ``sms`` only; C adds ``chain_tiles`` of 256."""
    gpb = _groups_per_block(G, n, sms)
    return {"groups_per_block": gpb, "splits": -(-G // gpb),
            "chain_tiles": -(-C // _CHAIN_TILE)}


def _check_kernel_args(X, y, shat, lamhat, theta, beta):
    tensors = (X, y, shat, lamhat, theta, beta)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if any(t.device != X.device for t in tensors):
        raise ValueError("all inputs must be on one device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"the kernel takes float32 only, got {[t.dtype for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if X.dim() != 3:
        raise ValueError(f"expected X (G, n, K), got {tuple(X.shape)}")
    G, n, K = X.shape
    C = theta.shape[0]
    if (tuple(y.shape) != (G, n) or tuple(shat.shape) != (G,) or tuple(lamhat.shape) != (G,)
            or tuple(theta.shape) != (C, G) or tuple(beta.shape) != (C, K)):
        raise ValueError(
            f"shape mismatch: X {tuple(X.shape)}, y {tuple(y.shape)}, shat {tuple(shat.shape)}, "
            f"lamhat {tuple(lamhat.shape)}, theta {tuple(theta.shape)}, beta {tuple(beta.shape)}"
        )
    if not (1 <= K <= _MAX_K):
        raise ValueError(f"the kernel takes 1 <= K <= {_MAX_K} covariates, got K={K}")
    if G < 1 or n < 1 or C < 1 or G * n * K >= 2**31 or C * G >= 2**31 or G > 65535 * _MAX_GROUPS:
        raise ValueError(f"sizes out of range: C={C}, G={G}, n={n}, K={K}")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    fn = _build.load("poisson_fused").poisson_fused
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def use_kernel_library(path) -> None:
    """Launch the kernel from the library at ``path``, a build of a variant
    of ``csrc/poisson_fused.cu`` (to time variants one after another in one
    process)."""
    _build.load("poisson_fused", path)
    _kernel_entry.cache_clear()


def fused_poisson_vag_cuda(X, y, shat, lamhat, theta, beta):
    """Launch the Hopper kernel: ``(ll (C,), r_theta (C, G), g_beta (C, K))``
    as :func:`fused_poisson_vag_reference` gives them. Raises on anything
    the kernel does not take. Launches on the current stream and adds one
    to ``fused_poisson_vag_cuda.launches`` (``_capture.count_launch``: a
    launch captured into a CUDA graph is added at each replay)."""
    _check_kernel_args(X, y, shat, lamhat, theta, beta)
    G, n, K = X.shape
    C = theta.shape[0]
    plan = launch_plan(G, n, C, sm_count(X.device.index or 0))
    f32 = dict(dtype=torch.float32, device=X.device)
    part = torch.empty((C * (1 + K), plan["splits"]), **f32)
    ll = torch.empty((C,), **f32)
    g_beta = torch.empty((C, K), **f32)
    r_theta = torch.empty((C, G), **f32)
    err = _kernel_entry()(
        X.data_ptr(), y.data_ptr(), shat.data_ptr(), lamhat.data_ptr(), theta.data_ptr(),
        beta.data_ptr(), part.data_ptr(), ll.data_ptr(), g_beta.data_ptr(), r_theta.data_ptr(),
        C, G, n, K, plan["groups_per_block"], torch.cuda.current_stream(X.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"poisson_fused launch failed with CUDA error {err}")
    _capture.pin(X, y, shat, lamhat)
    _capture.count_launch(fused_poisson_vag_cuda)
    return ll, r_theta, g_beta


fused_poisson_vag_cuda.launches = 0


def fused_poisson_value_and_grad(X, y, shat, lamhat, theta, beta):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if theta.device.type == "cpu":
        return fused_poisson_vag_reference(X, y, shat, lamhat, theta, beta)
    return fused_poisson_vag_cuda(X, y, shat, lamhat, theta, beta)


def make_fused_poisson_vag(prior_mu_scale: float = 5.0, prior_log_tau_scale: float = 1.0):
    """``vag(Z (C, D), data) -> (log_post (C,), grad (C, D))`` of the
    non-centered hierarchical Poisson regression with priors mu ~
    N(0, prior_mu_scale), log_tau ~ N(0, prior_log_tau_scale), theta_raw and
    beta ~ N(0, 1), over ``Z = [beta (K), log_tau, mu, theta_raw (G)]``, for
    ``data`` from :func:`prepare_fused_poisson_data`. The kernel gives the
    data terms; the chain rule through ``theta = mu + tau theta_raw`` and the
    priors are (C, G) elementwise work here."""
    inv_mu_var = 1.0 / (prior_mu_scale * prior_mu_scale)
    inv_lt_var = 1.0 / (prior_log_tau_scale * prior_log_tau_scale)
    log_norm = -math.log(prior_mu_scale) - math.log(prior_log_tau_scale)
    half_log_2pi = 0.5 * math.log(2.0 * math.pi)

    def vag(Z: torch.Tensor, data: dict):
        G, K = data["G"], data["K"]
        if Z.shape[-1] != K + 2 + G:
            raise ValueError(f"Z has {Z.shape[-1]} columns, the model has {K + 2 + G}")
        beta = Z[:, :K]
        log_tau = Z[:, K]
        mu = Z[:, K + 1]
        theta_raw = Z[:, K + 2:]
        tau = torch.exp(log_tau)
        theta = mu[:, None] + tau[:, None] * theta_raw
        ll, r_theta, g_beta = fused_poisson_value_and_grad(
            data["X"], data["y"], data["shat"], data["lamhat"], theta, beta.contiguous()
        )
        const = data["c0"] + log_norm - (K + 2 + G) * half_log_2pi
        lp = (
            ll
            + const
            - 0.5 * inv_mu_var * mu * mu
            - 0.5 * inv_lt_var * log_tau * log_tau
            - 0.5 * row_sum(theta_raw * theta_raw)
            - 0.5 * row_sum(beta * beta)
        )
        grad = torch.cat(
            [
                g_beta - beta,
                (tau * row_sum(r_theta * theta_raw) - inv_lt_var * log_tau)[:, None],
                (row_sum(r_theta) - inv_mu_var * mu)[:, None],
                tau[:, None] * r_theta - theta_raw,
            ],
            dim=1,
        )
        return lp, grad

    vag.graph_safe = True  # see inference/graphs.py
    return vag


def make_fused_poisson_model(prior_mu_scale: float = 5.0, prior_log_tau_scale: float = 1.0):
    """``(log_prob(params, data), vag)`` bound to one set of prior scales,
    so the density and gradient halves cannot diverge."""
    vag = make_fused_poisson_vag(prior_mu_scale, prior_log_tau_scale)

    def log_prob(params, data):
        z, _ = ravel_params(params)
        return vag(z[None], data)[0][0]

    return log_prob, vag
