"""Fused GLM log-likelihood + gradient for a batch of chains.

Counterpart of ``mlx_mcmc_tpu/ops/pallas/glm.py`` (the logistic and the
Gaussian linear likelihoods). For chain positions ``Z (C, D)``:

    s    = X z                                   per chain
    ll   = sum_i y_i s_i - softplus(s_i)         (logistic)
         = -1/2 sum_i (y_i - s_i)^2              (linear, unit noise)
    grad = X^T (y - sigmoid(s))  or  X^T (y - s)

``fused_logistic_vag_cuda`` and ``fused_linear_vag_cuda`` launch the two
entries of the hand-written Hopper kernel ``csrc/glm_fused.cu`` (bf16 X);
``fused_*_vag_reference`` are their plain PyTorch versions, which round
where the kernel rounds (Z and the residual to X's dtype).
``fused_*_value_and_grad`` take the plain version only for CPU tensors; for
CUDA tensors they launch the kernel or raise.

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
from mlx_mcmc_tpu_torch._device import resolve_device, sm_count

_ROW_TILE = 64  # rows per tile in the kernel (kRows)
_CHAIN_TILE = 64  # chains per block (kChains)
_MAX_D_PAD = 128  # kMaxDp
_BLOCKS_PER_SM = 3  # grid target: the ~64 KB of shared memory fits 3 per SM


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pack(X, y, quantize, num_shards: int, device):
    """``X`` keeps its dtype (pass bf16 for the kernel); its columns are
    padded with zeros to a multiple of 16, the depth of one tensor-core
    step. Rows are not padded. int8 storage and observation sharding are
    not ported."""
    if quantize is not None:
        raise NotImplementedError(f"quantize={quantize!r} is not ported yet")
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
    return Xp, yp, d


def prepare_fused_logistic_data(X, y, quantize=None, num_shards: int = 1, device=None) -> dict:
    """Pack a logistic-GLM dataset for :func:`make_fused_logistic_vag`
    (layout as :func:`_pack` says)."""
    Xp, yp, d = _pack(X, y, quantize, num_shards, device)
    return {"Xp": Xp, "yp": yp, "pad_const": 0.0, "dim": d}


def prepare_fused_linear_data(
    X, y, noise_scale: float = 1.0, quantize=None, num_shards: int = 1, device=None
) -> dict:
    """Pack a linear-regression dataset for :func:`make_fused_linear_vag`
    (layout as :func:`_pack` says). The noise scale travels in the data as
    ``inv_noise_var`` and the Gaussian normalizer as ``ll_norm``, so the vag
    cannot disagree with them."""
    Xp, yp, d = _pack(X, y, quantize, num_shards, device)
    return {
        "Xp": Xp,
        "yp": yp,
        "ll_norm": -0.5 * Xp.shape[0] * math.log(2.0 * math.pi * noise_scale**2),
        "inv_noise_var": 1.0 / noise_scale**2,
        "dim": d,
    }


def _logistic_epilogue(y, s):
    h = torch.tanh(0.5 * s)
    softplus = torch.clamp(s, min=0.0) - torch.log(0.5 + 0.5 * h.abs())
    return y * s - softplus, y - (0.5 + 0.5 * h)


def _gaussian_epilogue(y, s):
    r = y - s
    return -0.5 * (r * r), r


def _vag_reference(Xp, y, Z, epilogue):
    """Rounds at the kernel's points when ``Xp`` is bf16: ``Z`` to bf16
    before the first product and the residual to bf16 before the second.
    The products run in float32 on the rounded operands."""
    d = Z.shape[1]
    X = Xp[:, :d].float()
    s = Z.to(Xp.dtype).float() @ X.T  # (C, N)
    term, res = epilogue(y, s)
    return term.sum(dim=-1), res.to(Xp.dtype).float() @ X


def fused_logistic_vag_reference(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Plain PyTorch version of the logistic kernel, on any device:
    ``(ll (C,), grad (C, D))``, likelihood only."""
    return _vag_reference(Xp, y, Z, _logistic_epilogue)


def fused_linear_vag_reference(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Plain PyTorch version of the linear kernel, on any device:
    ``(-1/2 sum (y - X z)^2 (C,), X^T (y - X z) (C, D))``, unit noise,
    likelihood only."""
    return _vag_reference(Xp, y, Z, _gaussian_epilogue)


def _row_splits(n: int, c: int, device: torch.device):
    """Grid rows: enough row splits that (chain tiles x splits) fills the
    SMs about ``_BLOCKS_PER_SM`` deep. Returns (splits, rows_per_split)."""
    row_tiles = -(-n // _ROW_TILE)
    chain_tiles = -(-c // _CHAIN_TILE)
    want = -(-_BLOCKS_PER_SM * sm_count(device.index or 0) // chain_tiles)
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
def _kernel_entry(name: str):
    fn = getattr(_build.load("glm_fused"), name)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    _check_kernel_args(Xp, y, Z)
    fn = _kernel_entry(name)
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
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    return ll, g


def fused_logistic_vag_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Launch the logistic kernel: ``(ll (C,), grad (C, D))``, likelihood
    only. Raises on anything the kernel does not take. Launches on the
    current stream and adds one to ``fused_logistic_vag_cuda.launches``."""
    out = _launch("glm_fused_logistic", Xp, y, Z)
    fused_logistic_vag_cuda.launches += 1
    return out


def fused_linear_vag_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Launch the linear kernel: unit-noise ``(ll (C,), grad (C, D))``,
    likelihood only. Adds one to ``fused_linear_vag_cuda.launches``."""
    out = _launch("glm_fused_linear", Xp, y, Z)
    fused_linear_vag_cuda.launches += 1
    return out


fused_logistic_vag_cuda.launches = 0
fused_linear_vag_cuda.launches = 0


def fused_logistic_value_and_grad(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if Z.device.type == "cpu":
        return fused_logistic_vag_reference(Xp, y, Z)
    return fused_logistic_vag_cuda(Xp, y, Z)


def fused_linear_value_and_grad(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """The plain version for CPU tensors, the kernel for CUDA tensors."""
    if Z.device.type == "cpu":
        return fused_linear_vag_reference(Xp, y, Z)
    return fused_linear_vag_cuda(Xp, y, Z)


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


def make_fused_linear_vag(prior_scale: float = 1.0, include_prior: bool = True):
    """``vag(Z (C, D), data) -> (log_post (C,), grad (C, D))`` of the
    Gaussian linear-regression log-posterior with an N(0, prior_scale)
    prior, for ``data`` from :func:`prepare_fused_linear_data`.
    ``include_prior=False`` returns the likelihood terms only."""
    inv_var = 1.0 / (prior_scale * prior_scale)

    def vag(Z: torch.Tensor, data: dict):
        d = data["dim"]
        if Z.shape[-1] != d:
            raise ValueError(f"Z has {Z.shape[-1]} columns, data has dim {d}")
        ll, g = fused_linear_value_and_grad(data["Xp"], data["yp"], Z)
        ll = ll * data["inv_noise_var"] + data["ll_norm"]
        g = g * data["inv_noise_var"]
        if not include_prior:
            return ll, g
        log_norm = -0.5 * d * math.log(2.0 * math.pi * prior_scale * prior_scale)
        return ll + (log_norm - 0.5 * inv_var * (Z * Z).sum(dim=-1)), g - inv_var * Z

    return vag
