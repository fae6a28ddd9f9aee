"""Decompose the fused GLM kernel's time at the flagship shape, on the card.

Counterpart of the repository's ``benchmarks/flagship_decomposition.py``,
on the same operands (``make_operands``: numpy ``default_rng``, X (N_PAD,
D_PAD) bf16, y, Bt (D_PAD, C) bf16, here as Z = Bt^T):

  A. the variants of the kernel's body at (10,240, 128), C = 4096:
     ``mm1_sum``, ``mm1_pair`` (1,024-row tiles), ``floor_nosum``,
     ``floor``, ``current`` (the production kernel, ``glm_fused_logistic``,
     the MUFU epilogue) and ``split2``, with ``tanh_y`` (the accurate
     epilogue, split2's function) beside them;
  B. the fixed-FLOP depth sweep, (D_PAD, N_PAD) in (128, 10240), (256,
     5120), (512, 2560), (1024, 1280) at C = 4096, for ``floor`` and
     ``current``: above D_PAD = 128 both take the wide pair of kernels;
  C. the grid sweep, as a sweep of the one-pass kernel's rows per split for
     ``current`` (the chain tile is the kernel's 128; the reference's
     ``_pick_chain_tile`` has no counterpart).

``ceilings`` times ``torch.matmul`` in bf16 at 8192^3, 4096^3 and 10240 x
128 x 4096: yardsticks of what the library's GEMMs reach on this card,
beside the H100's data-sheet dense bf16 peak (989 TFLOP/s); the port never
calls them.

    python -m mlx_mcmc_tpu_torch.benchmarks.flagship_decomposition

Times are device ms per call from CUDA events with the host's enqueue
hidden (``bench.device_ms``) and per wrapper call (``call_ms``). Writes the
JSON to ``build/mlx_mcmc_tpu_torch/results/flagship_decomposition.json``
and prints it as the last line, with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch._device import sm_count
from mlx_mcmc_tpu_torch.bench import device_ms
from mlx_mcmc_tpu_torch.ops import glm, glm_variants

N, D, C = 10_000, 100, 4096
PEAK_BF16_TFLOPS = 989.0  # H100 SXM data sheet, dense, at 700 W
TILE_ROWS = 1024  # mm1_pair's row tile: the reference's tile_n in part A
ABLATION = ("mm1_sum", "mm1_pair", "floor_nosum", "floor", "current", "split2", "tanh_y")
DEPTHS = ((128, 10240), (256, 5120), (512, 2560), (1024, 1280))
GRID_ROWS = (None, 512, 1024, 2048, 2560, 5120)  # None: the default plan


def make_operands(n_pad: int, d_pad: int, c_pad: int, seed: int = 0, device="cuda"):
    """The reference's ``make_operands``: ``(Xp (n_pad, d_pad) bf16, yp
    (n_pad,), Z (c_pad, d_pad) f32 = Bt^T)``."""
    rng = np.random.default_rng(seed)
    Xp = torch.from_numpy(rng.normal(size=(n_pad, d_pad)).astype(np.float32) / np.sqrt(d_pad))
    yp = torch.from_numpy((rng.random((n_pad, 1)) < 0.5).astype(np.float32)[:, 0])
    Bt = torch.from_numpy(0.5 * rng.normal(size=(d_pad, c_pad)).astype(np.float32))
    Z = Bt.to(torch.bfloat16).float().T.contiguous()
    return Xp.to(torch.bfloat16).to(device), yp.to(device), Z.to(device)


def _variant_call(name, Xp, yp, Z, rows=None):
    if name == "current":
        if rows is None:
            return lambda: glm.fused_logistic_vag_cuda(Xp, yp, Z)
        return lambda: glm_variants.current_cuda(Xp, yp, Z, rows_per_split=rows)
    kernel = glm_variants.VARIANTS[name][0]
    if name == "mm1_pair":
        return lambda: kernel(Xp, yp, Z, tile_rows=TILE_ROWS)
    return lambda: kernel(Xp, yp, Z, rows_per_split=rows)


def _timed(call, flops: float) -> dict:
    ms = device_ms(call)
    tflops = flops / (ms * 1e-3) / 1e12
    return {"ms": ms, "call_ms": device_ms(call, hide_host=False), "padded_tflops": tflops,
            "pct_of_peak": 100 * tflops / PEAK_BF16_TFLOPS}


def ceilings(emit=print) -> list:
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in ((8192, 8192, 8192), (4096, 4096, 4096), (10240, 128, 4096)):
        a = torch.randn(m, k, generator=gen, device="cuda").bfloat16()
        b = torch.randn(k, n, generator=gen, device="cuda").bfloat16()
        row = dict({"shape": f"{m}x{k}x{n}"}, **_timed(lambda: torch.matmul(a, b), 2 * m * k * n))
        rows.append(row)
        emit(f"[ceiling] {row['shape']}: {row['ms']:.4f} ms, {row['padded_tflops']:.1f} TFLOP/s, "
             f"{row['pct_of_peak']:.1f}% of peak")
        del a, b
    return rows


def ablation(emit=print) -> list:
    """A: the variants at the flagship shape."""
    n_pad, d_pad = 10240, 128
    Xp, yp, Z = make_operands(n_pad, d_pad, C)
    flops = 4 * n_pad * d_pad * C
    useful = 4 * N * D * C
    rows = []
    for name in ABLATION:
        f = flops // 2 if name == "mm1_sum" else flops
        row = dict({"variant": name}, **_timed(_variant_call(name, Xp, yp, Z), f))
        row["useful_mfu_pct"] = row["pct_of_peak"] * useful / flops
        rows.append(row)
        emit(f"[ablation] {name:12s} {row['ms']:7.4f} ms (call {row['call_ms']:.4f})  "
             f"{row['padded_tflops']:6.1f} TFLOP/s  {row['pct_of_peak']:5.1f}% peak")
    return rows


def depth_sweep(emit=print) -> list:
    """B: the same FLOPs at deeper contractions."""
    rows = []
    for d_s, n_s in DEPTHS:
        Xs, ys, Zs = make_operands(n_s, d_s, C, seed=1)
        for name in ("floor", "current"):
            row = dict({"D_PAD": d_s, "N_PAD": n_s, "variant": name},
                       **_timed(_variant_call(name, Xs, ys, Zs), 4 * n_s * d_s * C))
            rows.append(row)
            emit(f"[depth] D_PAD={d_s:5d} N_PAD={n_s:6d} {name:8s} {row['ms']:7.4f} ms  "
                 f"{row['pct_of_peak']:5.1f}% peak")
        del Xs, ys, Zs
    return rows


def grid_sweep(emit=print) -> list:
    """C: the one-pass kernel's rows per split, for ``current``."""
    n_pad, d_pad = 10240, 128
    Xp, yp, Z = make_operands(n_pad, d_pad, C)
    plan = glm.launch_plan(n_pad, d_pad, C, sm_count(0))
    rows = []
    for r in GRID_ROWS:
        row = dict({"rows_per_split": r or plan["rows_per_split"],
                    "splits": -(-n_pad // r) if r else plan["splits"], "chain_tile": 128,
                    "default_plan": r is None},
                   **_timed(_variant_call("current", Xp, yp, Z, r), 4 * n_pad * d_pad * C))
        rows.append(row)
        emit(f"[grid] rows_per_split={row['rows_per_split']:5d} splits={row['splits']:3d} "
             f"{row['ms']:7.4f} ms  {row['pct_of_peak']:5.1f}% peak")
    return rows


def run(emit=print) -> dict:
    return {"shape": {"N": N, "D": D, "C": C, "N_PAD": 10240, "D_PAD": 128},
            "peak_bf16_tflops": PEAK_BF16_TFLOPS, "ceilings": ceilings(emit),
            "ablation": ablation(emit), "depth_sweep": depth_sweep(emit),
            "grid_sweep": grid_sweep(emit)}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = dict(run(lambda line: print(line, flush=True)), device=smi)
    results = _build.BUILD_DIR / "results"
    results.mkdir(parents=True, exist_ok=True)
    path = results / "flagship_decomposition.json"
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
