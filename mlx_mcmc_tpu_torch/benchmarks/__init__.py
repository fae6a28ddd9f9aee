"""The reference's benchmark scripts, on the card.

``glm_kernel_variants`` and ``flagship_decomposition`` are the
counterparts of the repository's ``benchmarks/glm_kernel_variants.py`` and
``benchmarks/flagship_decomposition.py``: they time the variants of the
fused GLM kernel's body (``ops/glm_variants.py``, ``csrc/glm_variants.cu``)
beside the production kernel; both need a GPU. ``nuts_overhead``,
``flagship_breakdown``, ``poisson_roofline`` and ``run_all`` are the
counterparts of the single-device scripts of the same names: where a NUTS
leapfrog's time goes, the flagship's warmup and sampling leaves and its
lockstep tax, K3 against autograd on the roofline, and ESS/s across kernels
and models. Run each with ``python -m``; each runs on the card, or where
``--device`` says (``--device cpu`` for a rehearsal), and fails without a
GPU unless asked for the CPU. Each prints its JSON with the card's name and
power limit as nvidia-smi gives them.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from mlx_mcmc_tpu_torch._device import resolve_device


def device_from_argv(argv=None) -> torch.device:
    """``--device DEV`` from ``argv`` (default ``sys.argv``), else CUDA;
    raises without a GPU unless the CPU was asked for."""
    argv = sys.argv if argv is None else argv
    return resolve_device(argv[argv.index("--device") + 1] if "--device" in argv else None)


def card(device: torch.device) -> str:
    """``name, power.limit`` of the card as nvidia-smi gives them, or
    ``"cpu"``."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def elapsed_ms(fn, device: torch.device):
    """``(fn(), ms)``: on the card from CUDA events around the call (the
    device's timeline from its first to its last work, host waits
    included), ended by a synchronize; on the CPU from the host clock."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)
