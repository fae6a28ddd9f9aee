"""Fused logistic-GLM log-likelihood + gradient for a batch of chains.

Counterpart of ``mlx_mcmc_tpu/ops/pallas/glm.py`` (the logistic half). For
chain positions ``Z (C, D)``:

    s    = X z               per chain
    ll   = sum_i y_i s_i - softplus(s_i)
    grad = X^T (y - sigmoid(s))

``fused_logistic_vag_cuda`` launches the hand-written Hopper kernel
``csrc/glm_fused.cu`` (bf16 X); ``fused_logistic_vag_reference`` is its
plain PyTorch version, which rounds where the kernel rounds (Z and the
residual to X's dtype). ``fused_logistic_value_and_grad`` takes the
reference only for CPU tensors; for CUDA tensors it launches the kernel or
raises.

The kernel masks the ragged last row tile itself, so the port's data carries
no padded rows and ``pad_const`` is 0. Data converted from the reference's
padded layout keeps its zero rows and their constant (``convert.py``).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch._device import resolve_device

_ROW_TILE = 64  # rows per tile in the kernel (kRows)
_CHAIN_TILE = 64  # chains per block (kChains)
_MAX_D_PAD = 128  # kMaxDp
_BLOCKS_PER_SM = 3  # grid target: the ~64 KB of shared memory fits 3 per SM


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prepare_fused_logistic_data(X, y, quantize=None, num_shards: int = 1, device=None) -> dict:
    """Pack a logistic-GLM dataset for :func:`make_fused_logistic_vag`.

    ``X`` keeps its dtype (pass bf16 for the kernel); its columns are padded
    with zeros to a multiple of 16, the depth of one tensor-core step. Rows
    are not padded. int8 storage and observation sharding are not ported.
    """
    if quantize is not None:
        raise NotImplementedError("quantize='int8' is not ported yet")
    if num_shards != 1:
        raise NotImplementedError("num_shards > 1 (observation sharding) is not ported yet")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    if not X.is_floating_point() or X.dim() != 2:
        raise ValueError(f"X must be a 2-D float tensor, got {X.dtype} {tuple(X.shape)}")
    n, d = X.shape
    Xp = X.new_zeros((n, _round_up(d, 16)))
    Xp[:, :d] = X
    yp = torch.as_tensor(y, dtype=torch.float32, device=dev).reshape(n).contiguous()
    return {"Xp": Xp, "yp": yp, "pad_const": 0.0, "dim": d}


def fused_logistic_vag_reference(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Plain PyTorch version of the kernel, on any device.

    Rounds at the kernel's points when ``Xp`` is bf16: ``Z`` to bf16 before
    the first product and the residual to bf16 before the second. The
    products run in float32 on the rounded operands. Returns
    ``(ll (C,), grad (C, D))``, likelihood only.
    """
    d = Z.shape[1]
    X = Xp[:, :d].float()
    s = Z.to(Xp.dtype).float() @ X.T  # (C, N)
    h = torch.tanh(0.5 * s)
    r = y - (0.5 + 0.5 * h)
    softplus = torch.clamp(s, min=0.0) - torch.log(0.5 + 0.5 * h.abs())
    ll = (y * s - softplus).sum(dim=-1)
    g = r.to(Xp.dtype).float() @ X
    return ll, g


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _row_splits(n: int, c: int, device: torch.device):
    """Grid rows: enough row splits that (chain tiles x splits) fills the
    SMs about ``_BLOCKS_PER_SM`` deep. Returns (splits, rows_per_split)."""
    row_tiles = -(-n // _ROW_TILE)
    chain_tiles = -(-c // _CHAIN_TILE)
    want = -(-_BLOCKS_PER_SM * _sm_count(device.index or 0) // chain_tiles)
    splits = max(1, min(row_tiles, want))
    rows_per_split = -(-row_tiles // splits) * _ROW_TILE
    return -(-n // rows_per_split), rows_per_split


def _check_kernel_args(Xp, y, Z):
    if not (Xp.is_cuda and y.is_cuda and Z.is_cuda):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if not (Xp.device == y.device == Z.device):
        raise ValueError("Xp, y and Z must be on one device")
    if Xp.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 X, got {Xp.dtype}")
    if y.dtype != torch.float32 or Z.dtype != torch.float32:
        raise ValueError(f"y and Z must be float32, got {y.dtype}, {Z.dtype}")
    if Xp.dim() != 2 or y.dim() != 1 or Z.dim() != 2:
        raise ValueError("expected Xp (N, Dp), y (N,), Z (C, D)")
    n, d_pad = Xp.shape
    c, d = Z.shape
    if y.shape[0] != n or n < 1 or c < 1:
        raise ValueError(f"shape mismatch: Xp {tuple(Xp.shape)}, y {tuple(y.shape)}, Z {tuple(Z.shape)}")
    if d_pad % 16 or d_pad > _MAX_D_PAD or d > d_pad:
        raise ValueError(
            f"the kernel takes D <= Dp <= {_MAX_D_PAD} with Dp a multiple of 16; "
            f"got D={d}, Dp={d_pad}"
        )
    if not (Xp.is_contiguous() and y.is_contiguous() and Z.is_contiguous()):
        raise ValueError("Xp, y and Z must be contiguous")
    if Xp.data_ptr() % 16:
        raise ValueError("Xp must be 16-byte aligned")
    if c * d >= 2**31:
        raise ValueError("C * D must fit in int32")


@functools.lru_cache(maxsize=None)
def _kernel_entry():
    fn = _build.load("glm_fused").glm_fused_logistic
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_logistic_vag_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Launch the Hopper kernel: ``(ll (C,), grad (C, D))``, likelihood only.

    Raises on anything the kernel does not take. Launches on the current
    stream and adds one to ``fused_logistic_vag_cuda.launches``.
    """
    _check_kernel_args(Xp, y, Z)
    fn = _kernel_entry()
    n, d_pad = Xp.shape
    c, d = Z.shape
    splits, rows_per_split = _row_splits(n, c, Xp.device)
    f32 = dict(dtype=torch.float32, device=Xp.device)
    ll_part = torch.empty((splits, c), **f32)
    g_part = torch.empty((splits, c, d), **f32)
    ll = torch.empty((c,), **f32)
    g = torch.empty((c, d), **f32)
    err = fn(
        Xp.data_ptr(), y.data_ptr(), Z.data_ptr(), ll_part.data_ptr(),
        g_part.data_ptr(), ll.data_ptr(), g.data_ptr(),
        n, d_pad, d, c, splits, rows_per_split,
        torch.cuda.current_stream(Xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"glm_fused_logistic launch failed with CUDA error {err}")
    fused_logistic_vag_cuda.launches += 1
    return ll, g


fused_logistic_vag_cuda.launches = 0


def fused_logistic_value_and_grad(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if Z.device.type == "cpu":
        return fused_logistic_vag_reference(Xp, y, Z)
    return fused_logistic_vag_cuda(Xp, y, Z)


def make_fused_logistic_vag(prior_scale: float = 1.0):
    """``vag(Z (C, D), data) -> (log_post (C,), grad (C, D))`` of the
    logistic log-posterior with an N(0, prior_scale) prior, for ``data``
    from :func:`prepare_fused_logistic_data`."""
    inv_var = 1.0 / (prior_scale * prior_scale)

    def vag(Z: torch.Tensor, data: dict):
        d = data["dim"]
        if Z.shape[-1] != d:
            raise ValueError(f"Z has {Z.shape[-1]} columns, data has dim {d}")
        ll, g = fused_logistic_value_and_grad(data["Xp"], data["yp"], Z)
        ll = ll + data["pad_const"]
        log_norm = -0.5 * d * math.log(2.0 * math.pi * prior_scale * prior_scale)
        return ll + (log_norm - 0.5 * inv_var * (Z * Z).sum(dim=-1)), g - inv_var * Z

    return vag
