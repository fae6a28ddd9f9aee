"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. Device: requires ``torch.cuda.is_available()``; prints the card's name
   and power limit as nvidia-smi gives them.
2. Build: compiles every CUDA source of the main path (``nvcc``, sm_90a)
   into ``build/mlx_mcmc_tpu_torch/`` and prints the build time and ptxas's
   register report.
3. Kernels against their plain versions on the card, at the main path's
   shape and at a ragged one, with CUDA-event timings and the bound.
4. Main path: ``glm100_fused`` at full width through ``sample()`` (100
   params, 10K obs, bf16 X, 4096 chains, 300 warmup + 2000 draws, depth 6,
   target 0.8, bf16 store), device min-ESS, kernel launch counts, host syncs,
   and the checks: accept 0.8 +- 0.05, mean tree depth < 5, divergence rate
   <= 1%, finite draws, posterior moments against a Laplace approximation.
5. Funnel detail: centered eight schools, 512 chains, target 0.9, depth 10,
   with warmup and draws cut from the bench's 400 + 400 to 200 + 100 so the
   whole smoke stays near half its time limit (the eager NUTS pair loop
   costs ~9 ms per iteration there; the full row took 922 s on the H100).
6. The kernels JSON line, then the contract line
   ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the reference package.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

H100_BF16_FLOPS = 989e12  # dense bf16 tensor-core peak, SXM, 700 W
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12  # HBM3

# K1 tolerances against the plain version, which rounds at the same points:
# - ll: both sum 10K f32 terms of O(1) in different orders (~1e-3 nats);
#   0.05 nats stays well below the 0.1-0.5 nats of noise that collapsed
#   adaptation in the reference (its rejected hoisted kernel).
# - g: a last-bit change of s in another summation order can flip the bf16
#   rounding of single residuals (one bf16 ulp, 2^-9 relative), which moves
#   g by about 1e-3 of max|g|.
LL_TOL_NATS = 0.05
G_TOL_REL, G_TOL_ABS = 1e-2, 1e-3


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def k1_bound_ms(n: int, d: int, c: int) -> tuple:
    """Least time for one K1 call: bytes (X bf16, y, Z in; ll, g out) over
    HBM rate, against the two products on bf16 tensor cores and ~12 f32
    operations per (row, chain) of the epilogue on the f32 units."""
    nbytes = n * d * 2 + n * 4 + c * d * 4 + c * 4 + c * d * 4
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(4.0 * n * d * c / H100_BF16_FLOPS, 12.0 * n * c / H100_F32_FLOPS)
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_k1(name, Xp, y, Z, timed: bool):
    from mlx_mcmc_tpu_torch.ops.glm import (
        fused_logistic_vag_cuda,
        fused_logistic_vag_reference,
    )

    ll_k, g_k = fused_logistic_vag_cuda(Xp, y, Z)
    ll_p, g_p = fused_logistic_vag_reference(Xp, y, Z)
    torch.cuda.synchronize()
    if not (torch.isfinite(ll_k).all() and torch.isfinite(g_k).all()):
        fail(f"K1 {name}: non-finite output")
    err_ll = float((ll_k - ll_p).abs().max())
    err_g = float((g_k - g_p).abs().max())
    g_max = float(g_p.abs().max())
    c, d = Z.shape
    n = Xp.shape[0]
    log(f"K1 {name}: C={c} N={n} D={d} max|dll|={err_ll:.3e} nats "
        f"max|dg|={err_g:.3e} (max|g|={g_max:.3e})")
    if err_ll > LL_TOL_NATS:
        fail(f"K1 {name}: ll error {err_ll} > {LL_TOL_NATS}")
    if err_g > G_TOL_REL * g_max + G_TOL_ABS:
        fail(f"K1 {name}: grad error {err_g} > {G_TOL_REL} * {g_max} + {G_TOL_ABS}")
    row = {"shape": [c, n, d], "max_abs_err_ll": err_ll, "max_abs_err_g": err_g}
    if timed:
        row["ms"] = cuda_time_ms(lambda: fused_logistic_vag_cuda(Xp, y, Z))
        row["plain_ms"] = cuda_time_ms(
            lambda: fused_logistic_vag_reference(Xp, y, Z), reps=5, inner=3
        )
        row["bound_ms"], row["bound_by"] = k1_bound_ms(n, d, c)
        log(f"K1 {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def laplace_check(data, beta_draws):
    """Posterior mean and sd of the GLM draws against a Laplace
    approximation (Newton MAP and inverse Hessian, float64, on the same
    bf16-rounded X). At N = 10K, D = 100 the two agree to ~0.1 sd."""
    d = data["dim"]
    X = data["Xp"][:, :d].double()
    y = data["yp"].double()
    b = torch.zeros(d, dtype=torch.float64, device=X.device)
    eye = torch.eye(d, dtype=torch.float64, device=X.device)
    for _ in range(50):
        p = torch.sigmoid(X @ b)
        grad = X.T @ (y - p) - b
        hess = (X * (p * (1 - p))[:, None]).T @ X + eye
        step = torch.linalg.solve(hess, grad)
        b = b + step
        if float(step.abs().max()) < 1e-12:
            break
    sd_lap = torch.sqrt(torch.diagonal(torch.linalg.inv(hess)))
    flat = beta_draws.reshape(-1, d)
    mean = torch.zeros(d, dtype=torch.float64, device=X.device)
    sq = torch.zeros(d, dtype=torch.float64, device=X.device)
    for chunk in flat.split(1 << 20):
        chunk = chunk.double()
        mean += chunk.sum(0)
        sq += (chunk * chunk).sum(0)
    mean /= flat.shape[0]
    sd = torch.sqrt(sq / flat.shape[0] - mean * mean)
    z_gap = float(((mean - b).abs() / sd_lap).max())
    sd_ratio = (sd / sd_lap)
    return z_gap, float(sd_ratio.min()), float(sd_ratio.max())


def main() -> None:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # --- build -----------------------------------------------------------
    from mlx_mcmc_tpu_torch import _build

    t0 = time.perf_counter()
    logs = _build.build(["glm_fused"], verbose=True)
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'up to date'})")
    for text in logs.values():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    from mlx_mcmc_tpu_torch.bench import CONFIGS, build_problem, run_config
    from mlx_mcmc_tpu_torch.ops.glm import fused_logistic_vag_cuda

    # --- K1 against its plain version -------------------------------------
    cfg = CONFIGS["glm100_fused"]
    problem = build_problem(cfg)
    data = problem[2]
    gen = torch.Generator(device="cuda").manual_seed(1)
    d = data["dim"]
    # unit-scale positions, as the main path's posterior gives (|s| ~ 1)
    z_main = torch.randn(cfg["num_chains"], d, generator=gen, device="cuda")
    k1_main = check_k1("main", data["Xp"], data["yp"], z_main, timed=True)
    n_r, d_r, c_r = 777, 37, 1000
    x_r = (torch.randn(n_r, d_r, generator=gen, device="cuda") / math.sqrt(d_r)).bfloat16()
    xp_r = torch.zeros(n_r, 48, dtype=torch.bfloat16, device="cuda")
    xp_r[:, :d_r] = x_r
    y_r = (torch.rand(n_r, generator=gen, device="cuda") < 0.5).float()
    z_r = torch.randn(c_r, d_r, generator=gen, device="cuda")
    check_k1("ragged", xp_r, y_r, z_r, timed=False)

    # --- main path ---------------------------------------------------------
    fused_logistic_vag_cuda.launches = 0
    metrics, result, _ = run_config(cfg, seed=1, problem=problem)
    k1_launches = fused_logistic_vag_cuda.launches
    metrics["k1_launches"] = k1_launches
    log("main path glm100_fused: " + json.dumps(metrics))
    beta = result.samples["beta"]
    want = (cfg["num_chains"], cfg["num_samples"], cfg["num_features"])
    if tuple(beta.shape) != want or beta.dtype != torch.bfloat16:
        fail(f"draws have shape {tuple(beta.shape)} {beta.dtype}, want {want} bfloat16")
    if not bool(torch.isfinite(beta).all()):
        fail("non-finite draws")
    if k1_launches == 0:
        fail("the main path launched K1 no time")
    if abs(metrics["mean_accept"] - 0.8) > 0.05:
        fail(f"mean accept {metrics['mean_accept']} outside 0.8 +- 0.05")
    if metrics["mean_tree_depth"] >= 5:
        fail(f"mean tree depth {metrics['mean_tree_depth']} >= 5 (trees at the cap)")
    if metrics["divergence_rate"] > 0.01:
        fail(f"divergence rate {metrics['divergence_rate']} > 1%")
    z_gap, sd_lo, sd_hi = laplace_check(data, beta)
    log(f"main path vs Laplace: max |mean - MAP| / sd = {z_gap:.4f}, "
        f"sd ratio in [{sd_lo:.4f}, {sd_hi:.4f}]")
    if z_gap > 0.25 or not (0.9 <= sd_lo and sd_hi <= 1.1):
        fail("posterior moments disagree with the Laplace approximation")
    del result, beta
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    # --- funnel detail -----------------------------------------------------
    fcfg = dict(CONFIGS["funnel8"], num_warmup=200, num_samples=100)
    fmetrics, fresult, _ = run_config(fcfg, seed=1)
    log("funnel8 (200 + 100): " + json.dumps(fmetrics))
    for k, v in fresult.samples.items():
        if v.shape[:2] != (fcfg["num_chains"], fcfg["num_samples"]):
            fail(f"funnel draws {k} have shape {tuple(v.shape)}")
        if not bool(torch.isfinite(v).all()):
            fail(f"funnel draws {k} are not finite")
    log(f"elapsed {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "glm_fused_logistic",
        "route": "cuda",
        "source": "mlx_mcmc_tpu_torch/csrc/glm_fused.cu",
        "replaces": "mlx_mcmc_tpu/ops/pallas/glm.py:49",
        "launches": k1_launches,
        "max_abs_err": max(k1_main["max_abs_err_ll"], k1_main["max_abs_err_g"]),
        "ms": k1_main["ms"],
        "plain_ms": k1_main["plain_ms"],
        "bound_ms": k1_main["bound_ms"],
        "bound_by": k1_main["bound_by"],
        "library_ms": None,
        "max_abs_err_ll": k1_main["max_abs_err_ll"],
        "max_abs_err_g": k1_main["max_abs_err_g"],
        "shape_c_n_d": k1_main["shape"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
