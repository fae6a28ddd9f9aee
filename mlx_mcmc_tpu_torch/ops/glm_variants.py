"""Microbenchmark variants of the fused GLM kernel's body.

Counterparts of the reference's kernel-body variants, which run through
``_fused_padded_call`` (``mlx_mcmc_tpu/ops/pallas/glm.py:185``):
``benchmarks/glm_kernel_variants.py`` (``floor``, ``tanh_y``,
``tanh_hoist``, ``exp_hoist``) and ``benchmarks/flagship_decomposition.py``
(``mm1_sum``, ``floor`` again, ``floor_nosum``, ``mm1_pair``, ``split2``).
They split the one-pass kernel's time into its parts and are on no
sampling path; ``mlx_mcmc_tpu_torch/benchmarks/`` runs them.

Each takes the reference's padded operands: ``Xp (N, Dp)`` bf16, ``y (N,)``
float32 (read by ``tanh_y`` and ``split2`` only) and ``Z (C, D)`` float32,
the reference's ``Bt`` transposed (bf16 values, so rounding Z to bf16 is
exact), and returns ``ll (C,)`` and ``g (C, D)``, summed over every row of
``Xp`` (rows of zeros included, as the reference sums its padding):

- ``floor``: ``ll = sum_rows s``, ``g = X^T bf16(s)``, ``s = X Z^T`` in f32;
- ``mm1_sum``: ``ll = sum_rows s``, ``g = 0``;
- ``floor_nosum``: ``ll = 0``, ``g = X^T bf16(s)``;
- ``tanh_y``: the logistic ll and g (K1) with the accurate tanh/log epilogue;
- ``tanh_hoist``: K4's body, ``sum softplus(s)`` and ``X^T bf16(sigmoid(s))``;
- ``exp_hoist``: the same outputs from ``t = exp(-|s|)``;
- ``split2``: ``tanh_y``'s function, each row stage in two halves;
- ``mm1_pair``: over row tiles of ``tile_rows`` rows, in order, per chain:
  ``ll += sum_rows s``, ``W = bf16(bf16(Z) + bf16(ll))``, ``ll += sum_rows
  X W^T``; ``g = 0``.

``<name>_reference`` is each one's plain PyTorch version (the reference's
formulas and casts: s in f32, the residual rounded to bf16 before the
second product); ``<name>_cuda`` launches its kernel of
``csrc/glm_variants.cu`` and adds one to its ``launches``; ``run(name,
...)`` takes the plain version for CPU tensors and the kernel for CUDA
tensors. The one-pass variants take ``rows_per_split`` (a multiple of 64:
the row range of one block, the counterpart of the reference's ``tile_n``),
by default :func:`~mlx_mcmc_tpu_torch.ops.glm.launch_plan`'s.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch._device import sm_count
from mlx_mcmc_tpu_torch.ops import glm

_ROW_TILE = 64  # rows per stage of the one-pass kernels (kORows)


def _floor_epilogue(y, s):
    return s, s


def _exp_hoisted_epilogue(y, s):
    del y
    t = torch.exp(-s.abs())
    inv = 1.0 / (1.0 + t)
    return torch.log1p(t) + torch.clamp(s, min=0.0), torch.where(s >= 0, inv, t * inv)


def _s(Xp, Z):
    return Z.to(torch.bfloat16).float() @ Xp[:, : Z.shape[1]].float().T  # (C, N)


def floor_reference(Xp, y, Z):
    return glm._vag_reference(Xp, y, Z, _floor_epilogue)


def mm1_sum_reference(Xp, y, Z):
    return _s(Xp, Z).sum(dim=-1), Z.new_zeros(Z.shape)


def floor_nosum_reference(Xp, y, Z):
    return Z.new_zeros(Z.shape[0]), floor_reference(Xp, y, Z)[1]


def tanh_y_reference(Xp, y, Z):
    return glm.fused_logistic_vag_reference(Xp, y, Z)


def tanh_hoist_reference(Xp, y, Z):
    return glm.fused_hoisted_vag_reference(Xp, Z)


def exp_hoist_reference(Xp, y, Z):
    return glm._vag_reference(Xp, y, Z, _exp_hoisted_epilogue)


split2_reference = tanh_y_reference  # the same function; only the ll sums group otherwise


def _tile_sum(s: torch.Tensor) -> torch.Tensor:
    """The sum over a row tile of ``s (C, R)`` in the kernel's order: per
    64-row stage and lane q in 0..3, rows 8 j + 2 q + e in the order of (j,
    e); the stages in order; then the lanes as (l0 + l1) + (l2 + l3). The
    order of a float32 sum is not the function's, but the same order keeps
    the plain version's running ll near the kernel's, and a few ulps can
    turn bf16(ll) (see :func:`mm1_pair_agreement`)."""
    c, r = s.shape
    s = torch.nn.functional.pad(s, (0, -r % _ROW_TILE)).reshape(c, -1, 8, 4, 2)
    q = torch.zeros_like(s[:, :, 0, :, 0])  # (C, stages, lanes)
    for j in range(8):
        for e in range(2):
            q = q + s[:, :, j, :, e]
    p = torch.zeros_like(q[:, 0])
    for stage in range(q.shape[1]):
        p = p + q[:, stage]
    return (p[:, 0] + p[:, 1]) + (p[:, 2] + p[:, 3])


def _flip_bf16(ll: torch.Tensor) -> torch.Tensor:
    """bf16(ll) rounded the other way: the bf16 neighbour on ll's other side."""
    lb = ll.to(torch.bfloat16)
    bits = lb.view(torch.int16).int()
    step = torch.where((lb.float() > 0) == (ll > lb.float()), 1, -1)
    return (bits + step).to(torch.int16).view(torch.bfloat16)


def _mm1_pair(Xp, Z, tile_rows: int, flip_tile=None):
    """The recurrence and, per chain, the least distance in float32 ulps of
    its running ll from a bf16 rounding boundary (where bf16(ll) turns).
    With ``flip_tile``, bf16(ll) is rounded the other way at that tile."""
    zb = Z.to(torch.bfloat16)
    d = Z.shape[1]
    ll = Z.new_zeros(Z.shape[0])
    margin = torch.full((Z.shape[0],), 1 << 16, dtype=torch.int32, device=Z.device)
    for t, r0 in enumerate(range(0, Xp.shape[0], tile_rows)):
        xt = Xp[r0:r0 + tile_rows, :d].float().T
        ll = ll + _tile_sum(zb.float() @ xt)
        low = ll.view(torch.int32) & 0xFFFF
        margin = torch.minimum(margin, (low - 0x8000).abs())
        lb = _flip_bf16(ll) if t == flip_tile else ll.to(torch.bfloat16)
        w = zb + lb[:, None]  # a bf16 add: float32 sum, rounded once
        ll = ll + _tile_sum(w.float() @ xt)
    return ll, margin


def mm1_pair_reference(Xp, y, Z, tile_rows: int = 1024):
    return _mm1_pair(Xp, Z, tile_rows)[0], Z.new_zeros(Z.shape)


def mm1_pair_agreement(Xp, Z, ll, tile_rows: int = 1024, rel_tol: float = 1e-4) -> dict:
    """Holds another implementation's mm1_pair ``ll`` to the plain version.

    The recurrence rounds the running ll to bf16 at every tile, and two
    correct implementations sum in other orders (and form s with other
    accumulations), so where ll passes near a bf16 rounding boundary, or is
    small beside the terms it sums, one of them may round it the other way,
    after which the chain's ll moves by a bf16 ulp of a product (~0.4%).
    Returns the chains whose running ll lies within one float32 ulp of a
    boundary at some tile (``boundary``), the chains off by more than
    ``rel_tol`` that the plain version with one bf16(ll) rounded the other
    way (at some tile) reproduces within ``rel_tol`` (``flipped``) and those
    it does not (``unexplained``), as index tensors, and the largest
    relative error off the flipped chains."""
    plain, margin = _mm1_pair(Xp, Z, tile_rows)
    rel = (ll - plain).abs() / plain.abs().clamp_min(1e-30)
    over = torch.nonzero(rel > rel_tol).flatten()
    explained = torch.zeros(over.numel(), dtype=torch.bool, device=ll.device)
    if over.numel():
        for t in range(-(-Xp.shape[0] // tile_rows)):
            alt = _mm1_pair(Xp, Z[over], tile_rows, flip_tile=t)[0]
            explained |= (ll[over] - alt).abs() <= rel_tol * alt.abs()
    flipped = over[explained]
    keep = torch.ones_like(rel, dtype=torch.bool)
    keep[flipped] = False
    return {"boundary": torch.nonzero(margin <= 1).flatten(), "flipped": flipped,
            "unexplained": over[~explained], "max_rel_err": float(rel[keep].max()),
            "margins_of_flipped": margin[flipped]}


def residual_flip(name: str, Xp: torch.Tensor, Z: torch.Tensor) -> float:
    """How far one flip of a residual's bf16 rounding moves g: max|x| times
    the bf16 ulp of the largest residual (s itself for the floor variants,
    below 1 in magnitude for the sigmoid ones). A last-bit change of s, or
    of exp or tanh, flips one now and then when two implementations are
    compared."""
    x_max = float(Xp.float().abs().max())
    if name in ("floor", "floor_nosum"):
        res_max = float(_s(Xp, Z).abs().max())
    else:
        res_max = 0.5  # |y - sigmoid| and sigmoid lie below 1: bf16 ulp 2^-8
    return x_max * 2.0 ** (math.floor(math.log2(max(res_max, 2.0 ** -126))) - 7)


def _plan(Xp: torch.Tensor, c: int, rows_per_split) -> dict:
    n, d_pad = Xp.shape
    plan = glm.launch_plan(n, d_pad, c, sm_count(Xp.device.index or 0), Xp.dtype)
    if rows_per_split is None:
        return plan
    if plan["path"] != "narrow" or rows_per_split <= 0 or rows_per_split % _ROW_TILE:
        raise ValueError(f"rows_per_split={rows_per_split}: the one-pass kernel (Dp <= 128) "
                         f"takes a positive multiple of {_ROW_TILE}")
    splits = -(-n // rows_per_split)
    return dict(plan, splits=splits, rows_per_split=rows_per_split, g_splits=splits,
                g_rows_per_split=rows_per_split)


def _check(Xp: torch.Tensor, y, Z: torch.Tensor):
    glm._check_kernel_args(Xp, y, Z)
    if Xp.dtype != torch.bfloat16:
        raise ValueError(f"the variants take bf16 X, as the reference's scripts run them; got {Xp.dtype}")


def _one_pass_variant(name: str):
    entry = f"glm_variant_{name}"

    def launch(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, rows_per_split=None):
        _check(Xp, y, Z)
        out = glm._launch(entry, Xp, y, Z, _plan(Xp, Z.shape[0], rows_per_split),
                          lib="glm_variants")
        launch.launches += 1
        return out

    launch.__name__ = launch.__qualname__ = f"{name}_cuda"
    launch.__doc__ = (f"Launch ``{entry}`` (csrc/glm_variants.cu): ``(ll (C,), g (C, D))``; "
                      f"adds one to ``{name}_cuda.launches``.")
    launch.launches = 0
    return launch


floor_cuda = _one_pass_variant("floor")
mm1_sum_cuda = _one_pass_variant("mm1_sum")
floor_nosum_cuda = _one_pass_variant("floor_nosum")
tanh_y_cuda = _one_pass_variant("tanh_y")
tanh_hoist_cuda = _one_pass_variant("tanh_hoist")
exp_hoist_cuda = _one_pass_variant("exp_hoist")
split2_cuda = _one_pass_variant("split2")


@functools.lru_cache(maxsize=None)
def _mm1_pair_entry():
    fn = _build.load("glm_variants").glm_variant_mm1_pair
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 6 + [i] * 5 + [p]
    fn.restype = ctypes.c_int
    return fn


def mm1_pair_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, tile_rows: int = 1024):
    """Launch ``glm_variant_mm1_pair``: ``(ll (C,), g = 0 (C, D))`` over row
    tiles of ``tile_rows`` rows (a multiple of 64); y is not read. Adds one
    to ``mm1_pair_cuda.launches``."""
    _check(Xp, None, Z)
    n, d_pad = Xp.shape
    c, d = Z.shape
    if d_pad > glm._MAX_D_PAD or tile_rows <= 0 or tile_rows % _ROW_TILE:
        raise ValueError(f"mm1_pair takes Dp <= {glm._MAX_D_PAD} and tile_rows a positive "
                         f"multiple of {_ROW_TILE}; got Dp={d_pad}, tile_rows={tile_rows}")
    ws = glm._workspace(Xp, c, d)  # the one-pass plan's zb and tensor maps
    ll = torch.empty((c,), dtype=torch.float32, device=Xp.device)
    g = torch.empty((c, d), dtype=torch.float32, device=Xp.device)
    err = _mm1_pair_entry()(Xp.data_ptr(), Z.data_ptr(), ll.data_ptr(), g.data_ptr(),
                            ws["zb"].data_ptr(), ws["maps"], n, d_pad, d, c, tile_rows,
                            torch.cuda.current_stream(Xp.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"glm_variant_mm1_pair launch failed with CUDA error {err}")
    mm1_pair_cuda.launches += 1
    return ll, g


mm1_pair_cuda.launches = 0


def current_cuda(Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, rows_per_split=None):
    """The production logistic entry (``glm_fused_logistic``, the MUFU
    epilogue) with the one-pass plan's rows per split given: the grid sweep
    of ``benchmarks/flagship_decomposition.py``. Adds one to
    ``current_cuda.launches``."""
    glm._check_kernel_args(Xp, y, Z)
    out = glm._launch("glm_fused_logistic", Xp, y, Z, _plan(Xp, Z.shape[0], rows_per_split))
    current_cuda.launches += 1
    return out


current_cuda.launches = 0

# name -> (kernel wrapper, plain version), in the reference's order.
VARIANTS = {
    "floor": (floor_cuda, floor_reference),
    "mm1_sum": (mm1_sum_cuda, mm1_sum_reference),
    "floor_nosum": (floor_nosum_cuda, floor_nosum_reference),
    "tanh_y": (tanh_y_cuda, tanh_y_reference),
    "tanh_hoist": (tanh_hoist_cuda, tanh_hoist_reference),
    "exp_hoist": (exp_hoist_cuda, exp_hoist_reference),
    "split2": (split2_cuda, split2_reference),
    "mm1_pair": (mm1_pair_cuda, mm1_pair_reference),
}


def run(name: str, Xp: torch.Tensor, y: torch.Tensor, Z: torch.Tensor, rows_per_split=None,
        tile_rows: int = 1024):
    """Variant ``name``: the plain version for CPU tensors, the kernel for
    CUDA tensors. ``rows_per_split`` is the one-pass kernels' plan (the
    plain versions do not depend on it); ``tile_rows`` is mm1_pair's."""
    kernel, plain = VARIANTS[name]
    cpu = Z.device.type == "cpu"
    if name == "mm1_pair":
        return (plain if cpu else kernel)(Xp, y, Z, tile_rows=tile_rows)
    return plain(Xp, y, Z) if cpu else kernel(Xp, y, Z, rows_per_split=rows_per_split)


def reset_launch_counts() -> None:
    for kernel, _ in VARIANTS.values():
        kernel.launches = 0


def launch_counts() -> dict:
    return {name: kernel.launches for name, (kernel, _) in VARIANTS.items()}
