"""Fused GLM log-likelihood + gradient for a batch of chains.

Counterpart of ``mlx_mcmc_tpu/ops/pallas/glm.py`` (the logistic, the
Gaussian linear and the hoisted-outcome likelihoods). For chain positions
``Z (C, D)``:

    s    = X z                                   per chain
    ll   = sum_i y_i s_i - softplus(s_i)         (logistic)
         = -1/2 sum_i (y_i - s_i)^2              (linear, unit noise)
    grad = X^T (y - sigmoid(s))  or  X^T (y - s)

``fused_logistic_vag_cuda``, ``fused_linear_vag_cuda`` and
``fused_hoisted_vag_cuda`` launch the three entries of the hand-written
Hopper kernels ``csrc/glm_fused.cu`` (bf16, int8 or f32 X; the linear one
not int8); ``fused_*_vag_reference`` are their plain PyTorch versions, which
round where the kernels round (Z and the residual to bf16 when X is bf16 or
int8, nowhere when X is f32). ``fused_*_value_and_grad`` take the plain
version only for CPU tensors; for CUDA tensors they launch the kernels or
raise. The kernels take any padded width ``Dp`` that is a multiple of 16;
:func:`launch_plan` says which path a shape takes: one TMA + wgmma pass over
X up to ``Dp = 128`` and two TMA + wgmma kernels above it (bf16, and int8
widened to bf16 in shared memory), two 3xTF32 TMA + wgmma kernels at any
``Dp`` (f32: each operand split into two tf32 parts, :func:`split_tf32`, so
the tensor cores give float32-class products; their gradient kernel reads
X^T, which f32 data carry as ``XpT``, :func:`transpose_f32`).

int8 data (``quantize="int8"``) stores X ~ Xq diag(col_scale) with
symmetric per-column scales, as the reference does; at the kernel level Z
is the scaled operand ``Z * col_scale`` and g comes back unscaled
(``make_fused_logistic_vag`` folds both).

The kernel masks the ragged last row tile itself, so the port's data carries
no padded rows and ``pad_const`` is 0, except for observation sharding
(``num_shards > 1``, ``parallel.sample_sharded(data_axis=...)``): there the
rows pad with zeros to a multiple of ``num_shards``, so that every shard
holds the same count, and the constants that each shard adds divide by
``num_shards``, so that the sum over the shards adds each once.
:func:`fused_data_specs` says how such data splits. Data converted from the
reference's padded layout keeps its zero rows and their constant
(``convert.py``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from mlx_mcmc_tpu_torch import _build, _capture
from mlx_mcmc_tpu_torch._device import resolve_device, sm_count
from mlx_mcmc_tpu_torch.ops.math import row_sum

_MAX_D_PAD = 128  # widest Dp of the one-pass kernel (kMaxDp)
_ROW_TILE = 64  # rows per tile of the one-pass kernel (kORows)
_NARROW_SPLITS = 4  # one-pass row splits: bounds the g partials (splits x C x Dp x 4 B)
_ONEPASS_CHAIN_TILE = 128  # one-pass kernel: chains per block (kOChains)
_WIDE_ROW_TILE = 128  # rows per tile, wide value kernel (kHRows)
_HOPPER_CHAIN_TILE = 256  # wide kernels: chains per block (kHChains)
_HOPPER_ROW_CHUNK = 64  # gradient kernel: rows per ring stage (kHK)
_HOPPER_D_TILE = 128  # gradient kernel: columns of g per block (kHCols)
_WALK_CHAIN_TILE = 128  # gradient kernel walking its splits: chains per block (g_chains(true))
# launch_plan's estimate of the wide gradient's two schedules, from the
# H100 (tools/wide_schedule.py): the tensor rate of one block (flop/s: the
# split schedule's 128 blocks ran glm1000_fused's 51.6 GFLOP in 0.104 ms,
# the walk's 256 blocks at C = 4096 826 GFLOP in 1.78 ms over two waves),
# the rate of the split schedule's scattered g partial stores (168 MB in
# its 0.20 ms at C = 4096, Dp = 1024, N = 1280) and sum_splits_kernel's
# (185 MB in 0.067 ms).
_GRAD_BLOCK_FLOPS = 3.7e12
_PARTIAL_STORE_BYTES_PER_S = 0.84e12
_SUM_SPLITS_BYTES_PER_S = 2.8e12
_TF32_ROW_TILE = 128  # f32 value kernel: rows per tile (kTRows)
_TF32_ROW_CHUNK = 32  # f32 gradient kernel: rows per ring stage (kTK)
_TF32_D_TILE = 128  # f32 gradient kernel: columns of g per block (kTCols)
_TF32_MIN_GRAD_ROWS = 512  # f32 gradient kernel: fewest rows per split (bounds g_part)
_X_DTYPE_CODE = {torch.bfloat16: 0, torch.int8: 1, torch.float32: 2}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _quantize_int8(X: torch.Tensor):
    """Symmetric per-column int8, as ``prepare_fused_logistic_data``
    (glm.py:521-525) of the reference: ``X ~ Xq * col_scale``."""
    Xf = X.float()
    col_scale = Xf.abs().amax(dim=0).clamp_min(1e-30) / 127.0
    return torch.clamp(torch.round(Xf / col_scale), -127, 127).to(torch.int8), col_scale


def _pack(X, y, quantize, num_shards: int, device):
    """``X`` keeps its dtype (bf16 or f32 for the kernels) or, with
    ``quantize="int8"``, is stored as int8 with per-column scales taken
    over all of X; its columns are padded with zeros to a multiple of 16,
    the depth of one tensor-core step, and its rows (and y's) to a
    multiple of ``num_shards``. Returns ``(Xp, yp, dim, col_scale or
    None, n)``, ``n`` the rows before padding."""
    if quantize not in (None, "int8"):
        raise ValueError(f"unknown quantize mode: {quantize!r}")
    if int(num_shards) < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    dev = resolve_device(device)
    X = torch.as_tensor(X, device=dev)
    if not X.is_floating_point() or X.dim() != 2:
        raise ValueError(f"X must be a 2-D float tensor, got {X.dtype} {tuple(X.shape)}")
    col_scale = None
    if quantize == "int8":
        X, col_scale = _quantize_int8(X)
    n, d = X.shape
    n_pad = _round_up(n, int(num_shards))
    Xp = X.new_zeros((n_pad, _round_up(d, 16)))
    Xp[:n, :d] = X
    yp = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    yp[:n] = torch.as_tensor(y, dtype=torch.float32, device=dev).reshape(n)
    return Xp, yp, d, col_scale, n


def prepare_fused_logistic_data(X, y, quantize=None, num_shards: int = 1, device=None) -> dict:
    """Pack a logistic-GLM dataset for :func:`make_fused_logistic_vag`
    (layout as :func:`_pack` says; int8 data also carry ``col_scale``).
    A zero row adds -log 2 to the likelihood; ``pad_const`` adds it back,
    divided by ``num_shards`` as the reference divides it (its
    ``glm.py:528-536``)."""
    Xp, yp, d, col_scale, n = _pack(X, y, quantize, num_shards, device)
    pad_const = (Xp.shape[0] - n) * math.log(2.0) / int(num_shards)
    data = {"Xp": Xp, "yp": yp, "pad_const": pad_const, "dim": d}
    if col_scale is not None:
        data["col_scale"] = col_scale
    if Xp.dtype == torch.float32:
        data["XpT"] = transpose_f32(Xp)
    return data


def prepare_fused_linear_data(
    X, y, noise_scale: float = 1.0, quantize=None, num_shards: int = 1, device=None
) -> dict:
    """Pack a linear-regression dataset for :func:`make_fused_linear_vag`
    (layout as :func:`_pack` says; no int8, as in the reference). The noise
    scale travels in the data as ``inv_noise_var`` and the Gaussian
    normalizer of the ``n`` observations as ``ll_norm``, divided by
    ``num_shards`` (the reference's ``glm.py:426-427``), so the vag cannot
    disagree with them. A zero row adds nothing to the sum of squares."""
    if quantize is not None:
        raise ValueError(f"quantize={quantize!r}: the linear kernel takes f32/bf16 X only")
    Xp, yp, d, _, n = _pack(X, y, None, num_shards, device)
    data = {
        "Xp": Xp,
        "yp": yp,
        "ll_norm": -0.5 * n * math.log(2.0 * math.pi * noise_scale**2) / int(num_shards),
        "inv_noise_var": 1.0 / noise_scale**2,
        "dim": d,
    }
    if Xp.dtype == torch.float32:
        data["XpT"] = transpose_f32(Xp)
    return data


def fused_data_specs(data: dict, data_axis: str = "data") -> dict:
    """How a fused-GLM data dict (:func:`prepare_fused_logistic_data`,
    :func:`prepare_fused_linear_data`) splits over a data axis
    (``sample_sharded(data_axis=..., data_specs=...)``; the reference's
    ``fused_data_specs``, ``glm.py:482-494``): ``Shard(0)`` for the rows
    (``Xp``, ``yp``), ``Shard(1)`` for ``XpT``, whose columns are the rows
    (each shard's is made again from its own rows by :func:`transpose_f32`:
    a column slice would be strided, and the f32 kernels' tensor maps take
    contiguous rows), and ``Replicate()`` for the rest (``dim``,
    ``pad_const``, ``col_scale``, ``ll_norm``, ``inv_noise_var``).
    ``data_axis`` names the axis, as in the reference; the placements do
    not depend on it."""
    from torch.distributed.tensor import Replicate, Shard

    del data_axis
    return {k: Shard(0) if k in ("Xp", "yp") else Shard(1) if k == "XpT" else Replicate()
            for k in data}


def transpose_f32(Xp: torch.Tensor) -> torch.Tensor:
    """X^T as the f32 gradient kernel reads it: ``(Dp, round_up(N, 4))``
    float32, zero past column N (TMA's row strides are multiples of 16
    bytes). A tf32 ``wgmma`` takes its B operand K-major only, so that
    kernel cannot read X itself. f32 data carry it as ``XpT``, made once
    with ``Xp``; the kernels trust it to be ``Xp``'s transpose."""
    n, d_pad = Xp.shape
    xt = Xp.new_zeros((d_pad, _round_up(n, 4)), dtype=torch.float32)
    xt[:, :n] = Xp.T
    return xt


def _logistic_epilogue(y, s):
    h = torch.tanh(0.5 * s)
    softplus = torch.clamp(s, min=0.0) - torch.log(0.5 + 0.5 * h.abs())
    return y * s - softplus, y - (0.5 + 0.5 * h)


def _gaussian_epilogue(y, s):
    r = y - s
    return -0.5 * (r * r), r


def _hoisted_epilogue(y, s):
    del y  # the hoisted kernel never reads y
    h = torch.tanh(0.5 * s)
    return torch.clamp(s, min=0.0) - torch.log(0.5 + 0.5 * h.abs()), 0.5 + 0.5 * h


def _operand_dtype(Xp: torch.Tensor) -> torch.dtype:
    """The type both products take: int8 X is widened to bf16."""
    return torch.bfloat16 if Xp.dtype == torch.int8 else Xp.dtype


def split_tf32(x: torch.Tensor):
    """``(hi, lo)`` of float32 ``x`` as the f32 kernels split their
    operands, bit for bit: ``hi = tf32(x)``, rounded to nearest to 11
    significant bits (a tf32 value, the low 13 bits zero) by Veltkamp's
    split in float32, ``c = x (2^13 + 1)``, ``hi = c - (c - x)``; and ``lo
    = tf32(x - hi)`` the same way. ``hi + lo`` is ``x`` to ~2^-22 of it;
    ``a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi`` (3xTF32)."""

    def tf32(v):
        c = v * 8193.0
        return c - (c - v)

    x = x.float()
    hi = tf32(x)
    return hi, tf32(x - hi)


def _vag_reference(Xp, y, Z, epilogue):
    """Rounds at the kernel's points when ``Xp`` is bf16 or int8: ``Z`` to
    bf16 before the first product and the residual to bf16 before the
    second (int8 values convert to float32 exactly). For f32 ``Xp`` nothing
    is rounded. The products run in float32 on the rounded operands."""
    d = Z.shape[1]
    X = Xp[:, :d].float()
    cdt = _operand_dtype(Xp)
    s = Z.to(cdt).float() @ X.T  # (C, N)
    term, res = epilogue(y, s)
    return term.sum(dim=-1), res.to(cdt).float() @ X


def vag_float64(family: str, Xp: torch.Tensor, y, Z: torch.Tensor):
    """``(ll (C,), grad (C, D))`` of the ``"logistic"``, ``"linear"`` or
    ``"hoisted"`` kernel's function (y unused; ll its sum of softplus)
    computed in float64 from the same X, y and Z, rounded nowhere: the
    yardstick of the f32 kernels' accuracy and their plain versions'."""
    X, Zd = Xp[:, :Z.shape[1]].double(), Z.double()
    s = Zd @ X.T
    if family == "linear":
        r = y.double() - s
        return (-0.5 * r * r).sum(-1), r @ X
    softplus = torch.logaddexp(s, torch.zeros_like(s))
    if family == "hoisted":
        return softplus.sum(-1), torch.sigmoid(s) @ X
    yd = y.double()
    return (yd * s - softplus).sum(-1), (yd - torch.sigmoid(s)) @ X


def fused_logistic_vag_reference(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Plain PyTorch version of the logistic kernel, on any device:
    ``(ll (C,), grad (C, D))``, likelihood only."""
    return _vag_reference(Xp, y, Z, _logistic_epilogue)


def fused_linear_vag_reference(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor):
    """Plain PyTorch version of the linear kernel, on any device:
    ``(-1/2 sum (y - X z)^2 (C,), X^T (y - X z) (C, D))``, unit noise,
    likelihood only."""
    return _vag_reference(Xp, y, Z, _gaussian_epilogue)


def fused_hoisted_vag_reference(Xp: torch.Tensor, Z: torch.Tensor):
    """Plain PyTorch version of the hoisted kernel, on any device:
    ``(sum_i softplus(s_i) (C,), X^T bf16(sigmoid(s)) (C, D))``."""
    return _vag_reference(Xp, None, Z, _hoisted_epilogue)


def _fixed_splits(n: int, row_tile: int, target: int):
    """``target`` splits of whole row tiles (fewer if n has fewer tiles),
    the last one possibly short. Returns (splits, rows_per_split)."""
    row_tiles = -(-n // row_tile)
    per_split = -(-row_tiles // max(1, min(row_tiles, target)))
    return -(-row_tiles // per_split), per_split * row_tile


def launch_plan(n: int, d_pad: int, c: int, sms: int, x_dtype=torch.bfloat16) -> dict:
    """The kernels' grid for X (n, d_pad) of ``x_dtype`` and c chains on
    ``sms`` SMs, with the scratch shapes (``zb_shape`` Z as the kernels read
    it, f32 on the f32 path and bf16 elsewhere; ``rt_shape`` the residual
    R^T of type ``rt_dtype``). ``path`` is
    ``"narrow"`` (one pass, Dp <= 128: the TMA + wgmma kernel), ``"wide"``
    (bf16, Dp > 128: the TMA + wgmma pair), ``"wide_int8"`` (int8, Dp >
    128: the same pair and schedule with tensor maps of bytes) or ``"f32"``
    (any Dp: the 3xTF32 pair on persistent grids of at most ``grid`` = sms
    blocks; Z padded to Dp, R^T with rows padded to a multiple of 4 for
    TMA's 16-byte strides).
    int8 X is widened to bf16 in shared memory on both TMA paths. On every
    path the row splits depend on n, Dp and ``sms`` only, never on c: a
    chain's ll and g are summed in the same order, to the same bits,
    whatever the number of chains in the call; chain tiles only add blocks
    (or, on the persistent f32 grids, work items).

    The wide paths' gradient takes one of two schedules of the same sums
    (``g_walk``), and only that choice depends on c. With ``g_walk``
    False, one block a (column tile, split, 256 chains) writes its split's
    g partial (``g_splits x C x D`` f32 in all, :func:`g_partial_shape`)
    and ``sum_splits_kernel`` adds them in split order. With ``g_walk``
    True, one block a (column tile, 128 chains) walks the splits in order,
    each into a fresh accumulator added to a running total in registers,
    and writes g: no partials. Both add a chain's split partials as ((p0 +
    p1) + p2) + ... in float32, from the same tensor-core sequence over the
    same rows, so they give the same bits. The walk is taken where it is
    estimated faster (:func:`_walk_is_faster`): each of its blocks runs all
    n rows, so few chains leave SMs idle for a whole walk, while the
    partials' round trip through device memory grows with c."""
    if x_dtype == torch.float32:
        # One chain tile's value items fill the SMs; the gradient's row
        # splits do so within each column tile, but keep at least
        # _TF32_MIN_GRAD_ROWS rows, so the g partials (g_splits x C x D)
        # stay small at many chains.
        splits, rows = _fixed_splits(n, _TF32_ROW_TILE, sms)
        g_target = min(sms // -(-d_pad // _TF32_D_TILE), -(-n // _TF32_MIN_GRAD_ROWS))
        g_splits, g_rows = _fixed_splits(n, _TF32_ROW_CHUNK, max(1, g_target))
        return {"path": "f32", "splits": splits, "rows_per_split": rows,
                "g_splits": g_splits, "g_rows_per_split": g_rows, "grid": sms,
                "zb_shape": (c, d_pad), "rt_shape": (c, _round_up(n, 4)),
                "rt_dtype": torch.float32}
    if d_pad <= _MAX_D_PAD:
        splits, rows = _fixed_splits(n, _ROW_TILE, _NARROW_SPLITS)
        return {"path": "narrow", "splits": splits, "rows_per_split": rows,
                "g_splits": splits, "g_rows_per_split": rows,
                "zb_shape": (_round_up(c, _ONEPASS_CHAIN_TILE), d_pad), "rt_shape": None}
    # One block per SM: the value kernel's row tiles spread over the SMs, the
    # gradient kernel's row chunks over the SMs left to each column tile.
    splits, rows = _fixed_splits(n, _WIDE_ROW_TILE, sms)
    g_splits, g_rows = _fixed_splits(n, _HOPPER_ROW_CHUNK, sms // -(-d_pad // _HOPPER_D_TILE))
    c_pad = _round_up(c, _HOPPER_CHAIN_TILE)
    path = "wide_int8" if x_dtype == torch.int8 else "wide"
    return {"path": path, "splits": splits, "rows_per_split": rows, "g_splits": g_splits,
            "g_rows_per_split": g_rows, "zb_shape": (c_pad, d_pad),
            "rt_shape": (c_pad, _round_up(n, _WIDE_ROW_TILE)), "rt_dtype": torch.bfloat16,
            "g_walk": _walk_is_faster(n, d_pad, c, sms, g_splits)}


def _walk_is_faster(n: int, d_pad: int, c: int, sms: int, g_splits: int) -> bool:
    """launch_plan's choice of the wide gradient's schedule, by estimated
    time. The walk: its waves of blocks, each the products of one 128 x 128
    tile over all n rows. One block a split: the same products spread over
    every SM, or the stores of the g partials where those take longer, then
    sum_splits_kernel's pass over them."""
    tiles = -(-d_pad // _HOPPER_D_TILE) * -(-c // _WALK_CHAIN_TILE)
    tile_s = n * 2 * _WALK_CHAIN_TILE * _HOPPER_D_TILE / _GRAD_BLOCK_FLOPS
    walk_s = -(-tiles // sms) * tile_s
    partials = 4 * g_splits * c * d_pad
    split_s = (max(tiles * tile_s / sms, partials / _PARTIAL_STORE_BYTES_PER_S)
               + (partials + 4 * c * d_pad) / _SUM_SPLITS_BYTES_PER_S)
    return walk_s < split_s and -(-c // _WALK_CHAIN_TILE) < 2**16  # the walk's grid.y


def g_partial_shape(plan: dict, c: int, d: int):
    """The g partials (``(g_splits, c, d)`` f32) that ``plan``'s gradient
    writes for c chains of D columns, or None where it writes g itself
    (the wide paths' walk)."""
    return None if plan.get("g_walk") else (plan["g_splits"], c, d)


def _check_kernel_args(Xp, y, Z, XpT=None):
    tensors = (Xp, Z) if y is None else (Xp, y, Z)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if any(t.device != Xp.device for t in tensors):
        raise ValueError("Xp, y and Z must be on one device")
    if Xp.dtype not in _X_DTYPE_CODE:
        raise ValueError(f"the CUDA kernel takes bf16, int8 or f32 X, got {Xp.dtype}")
    if Z.dtype != torch.float32 or (y is not None and y.dtype != torch.float32):
        raise ValueError(f"y and Z must be float32, got {None if y is None else y.dtype}, {Z.dtype}")
    if Xp.dim() != 2 or Z.dim() != 2 or (y is not None and y.dim() != 1):
        raise ValueError("expected Xp (N, Dp), y (N,), Z (C, D)")
    n, d_pad = Xp.shape
    c, d = Z.shape
    if (y is not None and y.shape[0] != n) or n < 1 or c < 1 or d < 1:
        raise ValueError(
            f"shape mismatch: Xp {tuple(Xp.shape)}, y {None if y is None else tuple(y.shape)}, "
            f"Z {tuple(Z.shape)}"
        )
    if d_pad % 16 or d > d_pad:
        raise ValueError(f"the kernel takes D <= Dp with Dp a multiple of 16; got D={d}, Dp={d_pad}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("Xp, y and Z must be contiguous")
    if Xp.data_ptr() % 16:
        raise ValueError("Xp must be 16-byte aligned")
    if c * d >= 2**31 or n >= 2**31:
        raise ValueError("C * D and N must fit in int32")
    if Xp.dtype == torch.float32:
        if XpT is None:
            raise ValueError("f32 X needs its transpose XpT (transpose_f32; f32 data carry it)")
        if (XpT.dtype != torch.float32 or XpT.device != Xp.device or not XpT.is_contiguous()
                or tuple(XpT.shape) != (d_pad, _round_up(n, 4))):
            raise ValueError(f"XpT must be transpose_f32(Xp): contiguous f32 ({d_pad}, "
                             f"{_round_up(n, 4)}) on Xp's device, got {XpT.dtype} "
                             f"{tuple(XpT.shape)} on {XpT.device}")


@functools.lru_cache(maxsize=None)
def _kernel_entry(name: str, lib: str = "glm_fused"):
    fn = getattr(_build.load(lib), name)
    p, i = ctypes.c_void_p, ctypes.c_int
    if name == "glm_hopper_tensor_maps":
        fn.argtypes = [p, i, p, p] + [i] * 4 + [p]
    elif name == "glm_tf32_tensor_maps":
        fn.argtypes = [p] * 4 + [i] * 5 + [p]
    elif name == "glm_onepass_tensor_maps":
        fn.argtypes = [p, i, p] + [i] * 3 + [p]
    else:
        fn.argtypes = [p, i] + [p] * 9 + [i] * 9 + [p]
    fn.restype = ctypes.c_int
    return fn


_WORKSPACES: "collections.OrderedDict" = collections.OrderedDict()
_MAX_WORKSPACES = 4


def _workspace(Xp: torch.Tensor, c: int, d: int, plan: dict = None, XpT=None) -> dict:
    """The launch plan (:func:`launch_plan`'s unless ``plan`` is given), split
    partials, scratch and tensor maps of X's type for X at ``Xp``'s address
    and shape with c chains of D columns, made once and kept for the next
    calls (the last few shapes), so the eager loop neither re-allocates nor
    re-encodes them and their pointers stay stable. Reusing them is safe on
    one stream, as the NUTS loop runs. On the f32 path the maps also name
    ``XpT`` (X^T, the caller's). A CUDA graph that captured a launch pins
    its workspace (``_capture.pin``), so an eviction here never frees
    memory that a graph still reads."""
    key = (Xp.device, Xp.data_ptr(), tuple(Xp.shape), Xp.dtype,
           None if XpT is None else XpT.data_ptr(), c, d,
           None if plan is None else tuple(sorted(plan.items())))
    ws = _WORKSPACES.get(key)
    if ws is not None:
        _WORKSPACES.move_to_end(key)
        return ws
    n, d_pad = Xp.shape
    dev = Xp.device
    if plan is None:
        plan = launch_plan(n, d_pad, c, sm_count(dev.index or 0), Xp.dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    g_shape = g_partial_shape(plan, c, d)
    ws = {"plan": plan, "ll_part": torch.empty((plan["splits"], c), **f32),
          "g_part": None if g_shape is None else torch.empty(g_shape, **f32), "zb": None,
          "rt": None, "maps": None}
    if plan["zb_shape"] is not None:
        zb_dtype = torch.float32 if plan["path"] == "f32" else torch.bfloat16
        ws["zb"] = torch.empty(plan["zb_shape"], dtype=zb_dtype, device=dev)
    if plan["rt_shape"] is not None:
        ws["rt"] = torch.empty(plan["rt_shape"], dtype=plan["rt_dtype"], device=dev)
    x_code = _X_DTYPE_CODE[Xp.dtype]
    if plan["path"] in ("wide", "wide_int8"):
        ws["maps"] = ctypes.create_string_buffer(4 * 128)
        c_pad, ldr = plan["rt_shape"]
        err = _kernel_entry("glm_hopper_tensor_maps")(
            Xp.data_ptr(), x_code, ws["zb"].data_ptr(), ws["rt"].data_ptr(), n, d_pad, c_pad,
            ldr, ws["maps"])
        if err != 0:
            raise RuntimeError(f"glm_hopper_tensor_maps failed with CUDA error {err}")
    elif plan["path"] == "f32":
        ws["maps"] = ctypes.create_string_buffer(4 * 128)
        err = _kernel_entry("glm_tf32_tensor_maps")(
            Xp.data_ptr(), XpT.data_ptr(), ws["zb"].data_ptr(), ws["rt"].data_ptr(), n,
            d_pad, c, XpT.shape[1], plan["rt_shape"][1], ws["maps"])
        if err != 0:
            raise RuntimeError(f"glm_tf32_tensor_maps failed with CUDA error {err}")
    elif plan["path"] == "narrow":
        ws["maps"] = ctypes.create_string_buffer(2 * 128)
        err = _kernel_entry("glm_onepass_tensor_maps")(
            Xp.data_ptr(), x_code, ws["zb"].data_ptr(), n, d_pad, plan["zb_shape"][0],
            ws["maps"])
        if err != 0:
            raise RuntimeError(f"glm_onepass_tensor_maps failed with CUDA error {err}")
    _WORKSPACES[key] = ws
    if len(_WORKSPACES) > _MAX_WORKSPACES:
        _WORKSPACES.popitem(last=False)
    return ws


def use_kernel_library(path) -> None:
    """Launch the GLM entries from the library at ``path``, a build of a
    variant of ``csrc/glm_fused.cu`` (to time variants one after another in
    one process). Forgets the entry points and workspaces of the library
    used before."""
    _build.load("glm_fused", path)
    _kernel_entry.cache_clear()
    _WORKSPACES.clear()


def _launch(name: str, Xp: torch.Tensor, y, Z: torch.Tensor, plan: dict = None,
            lib: str = "glm_fused", XpT=None):
    """Entry ``name`` of the library built from ``csrc/<lib>.cu`` (the
    signature of the GLM entries), with ``plan`` or :func:`launch_plan`'s."""
    _check_kernel_args(Xp, y, Z, XpT)
    fn = _kernel_entry(name, lib)
    n, d_pad = Xp.shape
    c, d = Z.shape
    ws = _workspace(Xp, c, d, plan, XpT if Xp.dtype == torch.float32 else None)
    plan = ws["plan"]
    ll = torch.empty((c,), dtype=torch.float32, device=Xp.device)
    g = torch.empty((c, d), dtype=torch.float32, device=Xp.device)

    def ptr(key):
        return None if ws[key] is None else ws[key].data_ptr()

    err = fn(
        Xp.data_ptr(), _X_DTYPE_CODE[Xp.dtype], None if y is None else y.data_ptr(),
        Z.data_ptr(), ptr("ll_part"), ptr("g_part"), ll.data_ptr(), g.data_ptr(), ptr("zb"),
        ptr("rt"), ws["maps"], n, d_pad, d, c, plan["splits"], plan["rows_per_split"],
        plan["g_splits"], plan["g_rows_per_split"], plan.get("grid", 0),
        torch.cuda.current_stream(Xp.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    _capture.pin(ws, Xp, y, XpT)
    return ll, g


def fused_logistic_vag_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, XpT=None):
    """Launch the logistic kernel: ``(ll (C,), grad (C, D))``, likelihood
    only; for int8 ``Xp``, ``Z`` is the scaled operand; f32 ``Xp`` needs
    ``XpT`` (:func:`transpose_f32`). Raises on anything the kernel does not
    take. Launches on the current stream and adds one to
    ``fused_logistic_vag_cuda.launches`` (``_capture.count_launch``: a
    launch captured into a CUDA graph is added at each replay)."""
    out = _launch("glm_fused_logistic", Xp, y, Z, XpT=XpT)
    _capture.count_launch(fused_logistic_vag_cuda)
    return out


def fused_linear_vag_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, XpT=None):
    """Launch the linear kernel: unit-noise ``(ll (C,), grad (C, D))``,
    likelihood only, bf16 or f32 ``Xp`` (f32 with ``XpT``). Adds one to
    ``fused_linear_vag_cuda.launches``."""
    if Xp.dtype == torch.int8:
        raise ValueError("the linear kernel takes bf16 or f32 X (no int8, as in the reference)")
    out = _launch("glm_fused_linear", Xp, y, Z, XpT=XpT)
    _capture.count_launch(fused_linear_vag_cuda)
    return out


def fused_hoisted_vag_cuda(Xp: torch.Tensor, Z: torch.Tensor, XpT=None):
    """Launch the hoisted kernel: ``(sum softplus(s) (C,), X^T
    bf16(sigmoid(s)) (C, D))``; it reads no y (f32 ``Xp`` with ``XpT``).
    Adds one to ``fused_hoisted_vag_cuda.launches``."""
    out = _launch("glm_fused_hoisted", Xp, None, Z, XpT=XpT)
    _capture.count_launch(fused_hoisted_vag_cuda)
    return out


fused_logistic_vag_cuda.launches = 0
fused_linear_vag_cuda.launches = 0
fused_hoisted_vag_cuda.launches = 0


def fused_logistic_value_and_grad(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, XpT=None):
    """The plain version for CPU tensors, the kernel for CUDA tensors
    (``XpT`` as the kernel takes it; the plain version does not read it)."""
    if Z.device.type == "cpu":
        return fused_logistic_vag_reference(Xp, y, Z)
    return fused_logistic_vag_cuda(Xp, y, Z, XpT)


def fused_linear_value_and_grad(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, XpT=None):
    """The plain version for CPU tensors, the kernel for CUDA tensors
    (``XpT`` as the kernel takes it; the plain version does not read it)."""
    if Z.device.type == "cpu":
        return fused_linear_vag_reference(Xp, y, Z)
    return fused_linear_vag_cuda(Xp, y, Z, XpT)


def fused_hoisted_value_and_grad(Xp: torch.Tensor, Z: torch.Tensor, XpT=None):
    """The plain version for CPU tensors, the kernel for CUDA tensors
    (``XpT`` as the kernel takes it; the plain version does not read it)."""
    if Z.device.type == "cpu":
        return fused_hoisted_vag_reference(Xp, Z)
    return fused_hoisted_vag_cuda(Xp, Z, XpT)


def hoisted_outcomes(Xp: torch.Tensor, y: torch.Tensor, dim: int) -> torch.Tensor:
    """``X^T y (D,)`` in float32 from the stored X: the data-prep constant
    that the hoisted kernel moves out of its loop."""
    return y.float() @ Xp[:, :dim].float()


def hoisted_logistic_value_and_grad(Xp: torch.Tensor, yX: torch.Tensor, Z: torch.Tensor,
                                    XpT=None):
    """The logistic likelihood rebuilt from the hoisted kernel, as the
    reference's benchmark rebuilds it (benchmarks/glm_kernel_variants.py:186,
    216-220): ``ll = yX . bf16(z) - sum softplus(s)`` and ``g = yX - X^T
    sigmoid(s)``, with ``yX`` from :func:`hoisted_outcomes`.

    Not a sampling path, and no ``make_*_vag`` offers it: ``ll`` is the
    difference of two float32 sums of order N, so it carries rounding noise
    of order ulp(N) (0.1-0.5 nats at N = 10K), which no step size can
    reduce; NUTS adaptation collapsed on it in the reference
    (mlx_mcmc_tpu/ops/pallas/glm.py:125-136, docs/DESIGN.md §4b). It is
    kept beside K1 as a kernel held against its plain version."""
    sp, gs = fused_hoisted_value_and_grad(Xp, Z, XpT)
    zr = Z.to(_operand_dtype(Xp)).float()
    return zr @ yX - sp, yX - gs


def make_fused_logistic_vag(prior_scale: float = 1.0, include_prior: bool = True):
    """``vag(Z (C, D), data) -> (log_post (C,), grad (C, D))`` of the
    logistic log-posterior with an N(0, prior_scale) prior, for ``data``
    from :func:`prepare_fused_logistic_data`. int8 data fold their column
    scales into the kernel's Z operand and out of its gradient
    (glm.py:580-606). ``include_prior=False`` returns the likelihood
    terms only (``pad_const`` included): what each shard of observation
    sharding adds up, the prior coming once after the sum."""
    inv_var = 1.0 / (prior_scale * prior_scale)

    def vag(Z: torch.Tensor, data: dict):
        d = data["dim"]
        if Z.shape[-1] != d:
            raise ValueError(f"Z has {Z.shape[-1]} columns, data has dim {d}")
        col_scale = data.get("col_scale")
        Z_op = Z if col_scale is None else Z * col_scale
        ll, g = fused_logistic_value_and_grad(data["Xp"], data["yp"], Z_op, data.get("XpT"))
        if col_scale is not None:
            g = g * col_scale
        ll = ll + data["pad_const"]
        if not include_prior:
            return ll, g
        log_norm = -0.5 * d * math.log(2.0 * math.pi * prior_scale * prior_scale)
        return ll + (log_norm - 0.5 * inv_var * row_sum(Z * Z)), g - inv_var * Z

    vag.graph_safe = True  # see inference/graphs.py
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
        ll, g = fused_linear_value_and_grad(data["Xp"], data["yp"], Z, data.get("XpT"))
        ll = ll * data["inv_noise_var"] + data["ll_norm"]
        g = g * data["inv_noise_var"]
        if not include_prior:
            return ll, g
        log_norm = -0.5 * d * math.log(2.0 * math.pi * prior_scale * prior_scale)
        return ll + (log_norm - 0.5 * inv_var * row_sum(Z * Z)), g - inv_var * Z

    vag.graph_safe = True
    return vag
