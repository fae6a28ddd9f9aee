"""Microbenchmark: the fused GLM kernel's epilogue variants, on the card.

Counterpart of the repository's ``benchmarks/glm_kernel_variants.py``, on
the same operands (numpy ``default_rng(0)``: N = 10,000 rows of D = 100
padded to (10,240, 128) bf16, y padded with zeros, C = 4096 chain
positions as bf16 values): each variant of the kernel's body
(``ops/glm_variants.py``) beside ``current``, the production logistic
kernel (``glm_fused_logistic``, the MUFU epilogue), with the reference's
numeric check against a float32 autograd oracle on the bf16-rounded X (the
hoisted variants rebuilt from X^T y; the padded rows' -log 2 taken out).

    python -m mlx_mcmc_tpu_torch.benchmarks.glm_kernel_variants

Times: device ms per call from CUDA events with the host's enqueue hidden
(``bench.device_ms``), and per wrapper call when the host sets the pace
(``call_ms``); TFLOP/s of the padded products, 4 N_PAD D_PAD C. The
reference's ``tile_n`` loop (512, 1024, 2048) is a sweep of the one-pass
kernel's rows per split, its counterpart (the default plan's 2,560 rows
are a row of their own). The reference's loop of 300 calls with the
``1e-30 g`` feedback, there to keep XLA from folding them, has no
counterpart: every call here launches its kernels. Prints one line per
(rows, variant), then a JSON line with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from mlx_mcmc_tpu_torch.bench import device_ms
from mlx_mcmc_tpu_torch.ops import glm, glm_variants

N, D, C = 10_000, 100, 4096
N_PAD, D_PAD = 10_240, 128
ROWS_PER_SPLIT = (None, 512, 1024, 2048)  # None: the default plan
VARIANTS = ("current", "floor", "tanh_y", "tanh_hoist", "exp_hoist")
HOISTED = ("tanh_hoist", "exp_hoist")
SWEPT = ("current", "tanh_hoist", "tanh_y")  # the variants the reference times at every tile_n


def make_operands(device="cuda"):
    """The reference's ``main()`` operands: ``(Xp (N_PAD, D_PAD) bf16, yp
    (N_PAD,), Z (C, D_PAD) f32 = Bt^T, y (N,))``."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(N, D)).astype(np.float32) / np.sqrt(D)
    beta_true = rng.normal(size=(D,)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = (rng.random(N) < p).astype(np.float32)
    Z = rng.normal(size=(C, D)).astype(np.float32) * 0.5
    Xp = torch.zeros((N_PAD, D_PAD), dtype=torch.bfloat16)
    Xp[:N, :D] = torch.from_numpy(X).to(torch.bfloat16)
    yp = torch.zeros(N_PAD)
    yp[:N] = torch.from_numpy(y)
    Zp = torch.zeros((C, D_PAD))
    Zp[:, :D] = torch.from_numpy(Z).to(torch.bfloat16).float()
    return Xp.to(device), yp.to(device), Zp.to(device), torch.from_numpy(y).to(device)


def oracle(X, y, Z):
    """The reference's oracle: float32 autograd of ``sum y s - softplus(s)``
    per chain, ``s = X z``, for X (N, D) (the bf16-rounded design), y (N,)
    and Z (C, D): ``(ll (C,), g (C, D))``."""
    z = Z.clone().requires_grad_(True)
    s = z @ X.T
    ll = (y * s - (torch.clamp(s, min=0.0) + torch.log1p(torch.exp(-s.abs())))).sum(dim=-1)
    (g,) = torch.autograd.grad(ll.sum(), z)
    return ll.detach(), g


def _call(name, Xp, yp, Z, rows):
    if name == "current":
        if rows is None:
            return lambda: glm.fused_logistic_vag_cuda(Xp, yp, Z)
        return lambda: glm_variants.current_cuda(Xp, yp, Z, rows_per_split=rows)
    kernel = glm_variants.VARIANTS[name][0]
    return lambda: kernel(Xp, yp, Z, rows_per_split=rows)


def run(emit=print) -> list:
    """Every (rows per split, variant) the reference times: one row each."""
    Xp, yp, Z, y = make_operands()
    X = Xp[:N, :D].float()
    ll_ref, g_ref = oracle(X, y, Z[:, :D])
    yX = X.T @ y  # (D,) hoisted constants
    pad_rows = N_PAD - N
    flops = 4 * N_PAD * D_PAD * C
    rows_out = []
    for rows in ROWS_PER_SPLIT:
        for name in VARIANTS:
            if rows != 1024 and rows is not None and name not in SWEPT:
                continue
            call = _call(name, Xp, yp, Z, rows)
            ms = device_ms(call)
            call_ms = device_ms(call, hide_host=False)
            ll_pad, g_pad = call()
            if name == "floor":
                dll = dg = None
            else:
                if name in HOISTED:
                    ll = Z[:, :D] @ yX - (ll_pad - pad_rows * np.log(2.0))
                    g = yX - g_pad[:, :D]
                else:
                    ll = ll_pad + pad_rows * np.log(2.0)
                    g = g_pad[:, :D]
                dll = float((ll - ll_ref).abs().max()) / max(1.0, float(ll_ref.abs().max()))
                dg = float((g - g_ref).abs().max()) / max(1.0, float(g_ref.abs().max()))
            row = {"rows_per_split": rows, "variant": name, "ms": ms, "call_ms": call_ms,
                   "tflops": flops / (ms * 1e-3) / 1e12, "rel_dll": dll, "rel_dg": dg}
            rows_out.append(row)
            check = "n/a" if dll is None else f"rel_dll={dll:.2e} rel_dg={dg:.2e}"
            emit(f"rows_per_split={rows or 'plan'!s:>5} {name:10s} {ms:7.4f} ms/call "
                 f"(call {call_ms:.4f})  {row['tflops']:6.1f} TFLOP/s  {check}")
    return rows_out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"{smi}; shapes: Xp ({N_PAD}, {D_PAD}) bf16, C={C}", flush=True)
    rows = run(lambda line: print(line, flush=True))
    print(json.dumps({"device": smi, "rows": rows}))


if __name__ == "__main__":
    main()
