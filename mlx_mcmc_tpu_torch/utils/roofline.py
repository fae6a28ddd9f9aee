"""Roofline and MFU accounting for the sampler's hot op, the GLM value+grad.

Counterpart of ``mlx_mcmc_tpu/utils/roofline.py``, with the same flop and
byte models and the same report, rounded the same way. The peaks are the
card's: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense
rates (no sparsity). A card whose name no entry matches, and the CPU, give
``(None, None)``, and the report then holds only the achieved rate.

The peak depends on the operands' type. TF32 is off on every path of the
port (``_device.py``), so products on float32 X run on the float32 units
(67 TFLOP/s), not on the tensor cores; bf16 X runs on the tensor cores (989
TFLOP/s), and so does int8 X, which the fused kernels widen to bf16 for
their products (``csrc/glm_fused.cu``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# card name (lower case, as ``torch.cuda.get_device_name`` gives it)
# -> ({operand dtype: dense peak TFLOP/s}, HBM GB/s)
DEVICE_PEAKS = {
    "h100 80gb hbm3": (
        {torch.bfloat16: 989.0, torch.float16: 989.0, torch.int8: 989.0, torch.float32: 67.0},
        3350.0,
    ),
}


def device_peaks(device, dtype=torch.bfloat16) -> Tuple[Optional[float], Optional[float]]:
    """(peak TFLOP/s for ``dtype`` operands, HBM GB/s) of ``device``: a
    ``torch.device`` or the card's name as ``torch.cuda.get_device_name``
    gives it. ``(None, None)`` for the CPU, a card no entry names, or a
    dtype its entry lacks."""
    if isinstance(device, str):
        name = device
    else:
        device = torch.device(device)
        if device.type != "cuda":
            return (None, None)
        name = torch.cuda.get_device_name(device)
    name = name.lower()
    for sub, (flops, hbm_gbs) in DEVICE_PEAKS.items():
        if sub in name and dtype in flops:
            return (flops[dtype], hbm_gbs)
    return (None, None)


def glm_vag_flops(num_obs: int, num_features: int, chains: int = 1) -> float:
    """Flops of ONE fused GLM value+grad evaluation: forward (N,D)@(D,C)
    plus backward X^T r, 4*N*D per chain."""
    return 4.0 * num_obs * num_features * chains


def glm_vag_bytes(
    num_obs: int, num_features: int, itemsize: int = 4, x_reads: float = 1.0
) -> float:
    """Dominant HBM bytes of one evaluation: the design-matrix stream.
    ``x_reads``: 1 for the fused single-pass kernel, 2 for autograd
    (forward and backward each read X)."""
    return num_obs * num_features * itemsize * x_reads


def roofline_report(
    flops: float,
    bytes_accessed: float,
    wall_seconds: float,
    device,
    dtype=torch.bfloat16,
) -> dict:
    """Achieved TFLOP/s, MFU %, arithmetic intensity, and the roofline bound
    ``min(peak, AI * bandwidth)`` with the achieved fraction of that bound,
    against :func:`device_peaks` of ``device`` for ``dtype`` operands."""
    achieved_tflops = flops / wall_seconds / 1e12
    out = {"achieved_tflops": round(achieved_tflops, 2)}
    peak_tflops, hbm_gbs = device_peaks(device, dtype)
    if peak_tflops:
        ai = flops / max(bytes_accessed, 1.0)
        bound = min(peak_tflops, ai * hbm_gbs / 1e3)
        out.update(
            mfu_pct=round(100.0 * achieved_tflops / peak_tflops, 2),
            arithmetic_intensity=round(ai, 1),
            roofline_bound_tflops=round(bound, 1),
            roofline_frac_pct=round(100.0 * achieved_tflops / bound, 2),
            peak_tflops=peak_tflops,
            hbm_gbs=hbm_gbs,
        )
    return out
