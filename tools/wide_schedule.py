"""The wide GLM pair (Dp > 128, bf16 and int8 X) at many chains, on the card.

    PYTHONPATH=. python3 tools/wide_schedule.py [--against ROOT] [--out PATH]   # from the repository's root

Times, with the device's time per CUDA kernel beside each total:

- ``floor`` (``glm_variants.floor_cuda``) and ``current`` (the production
  logistic entry, ``glm.fused_logistic_vag_cuda``) on the depth sweep's
  operands (``benchmarks/flagship_decomposition.make_operands``, seed 1) at
  (N, Dp) = (5120, 256) and (1280, 1024), C = 4096;
- K1 wide, K1 on int8 X and K2 wide at glm1000_fused's shape (C = 256, N =
  100K, D = 1000; the config's data, unit-scale positions), and K1 wide
  there at C = 4096.

Each case prints its launch plan, the device ms per call with the host's
enqueue hidden (``bench.device_ms``), the device ms of each CUDA kernel a
call launches (``bench.kernels_ms``) and the two products as
``torch.matmul`` (``chip_smoke.products_yardstick_ms``, the yardstick).
With ``--against ROOT``, the package of another checkout unpacked at ROOT
(e.g. ``git archive HEAD~ | tar -x -C build/parent``) runs each case on the
same inputs in turns (other, this, this, other), and each case says whether
the two packages gave the same bits. Writes the JSON to ``--out`` (default
``build/mlx_mcmc_tpu_torch/results/wide_schedule.json``) and prints it as
the last line, after the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import torch

from chip_smoke import products_yardstick_ms
from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch._device import sm_count
from mlx_mcmc_tpu_torch.bench import CONFIGS, build_problem, device_ms, kernels_ms, module_from
from mlx_mcmc_tpu_torch.benchmarks.flagship_decomposition import make_operands
from mlx_mcmc_tpu_torch.ops import glm, glm_variants


def timed_in_turns(calls: dict) -> dict:
    """{"ms": {package: [device ms, ...]}, "kernels_ms": {package: {kernel:
    ms}}} of ``calls`` ({"this": call} or {"this": ..., "other": ...}),
    timed in turns: other, this, this, other (this, this alone)."""
    order = ["other", "this", "this", "other"] if "other" in calls else ["this", "this"]
    row = {"ms": {k: [] for k in calls}, "kernels_ms": {}}
    for key in order:
        row["ms"][key].append(device_ms(calls[key]))
    for key in calls:
        row["kernels_ms"][key] = kernels_ms(calls[key])
    return row


def tool_main(run, out_name: str, flags=()) -> None:
    """A tool's ``main``: ``--against ROOT``, ``--out PATH`` (default
    ``build/mlx_mcmc_tpu_torch/results/<out_name>``) and the tool's own
    switches ``flags``; prints the card's name and power limit, calls
    ``run(args)``, writes its dict with the card and the torch version to
    ``--out`` and prints it as the last line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", default=None)
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "results" / out_name))
    for flag in flags:
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    out = dict(run(args), device=smi, torch=torch.__version__)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    print(f"wrote {path}", flush=True)
    print(json.dumps(out))


def _cases():
    """(label, make_inputs, family) with make_inputs() -> (Xp, y, Z)."""
    def sweep(n, d_pad):
        return lambda: make_operands(n, d_pad, 4096, seed=1)

    cache = {}

    def glm1000(family, chains, int8=False):
        def make():
            cfg = CONFIGS["glm1000_fused"]
            key = (family, int8)
            if key not in cache:
                cache.clear()
                cache[key] = build_problem(dict(cfg, family=family,
                                                quantize="int8" if int8 else None))[2]
            data = cache[key]
            gen = torch.Generator(device="cuda").manual_seed(1)
            Z = torch.randn(chains, data["dim"], generator=gen, device="cuda")
            if int8:
                Z = Z * data["col_scale"]
            return data["Xp"], data["yp"], Z
        return make

    return [("floor Dp=256", sweep(5120, 256), "floor"),
            ("floor Dp=1024", sweep(1280, 1024), "floor"),
            ("current Dp=256", sweep(5120, 256), "logistic"),
            ("current Dp=1024", sweep(1280, 1024), "logistic"),
            ("K1 wide glm1000", glm1000("glm", 256), "logistic"),
            ("K1 int8 wide glm1000", glm1000("glm", 256, int8=True), "logistic"),
            ("K2 wide glm1000", glm1000("linear", 256), "linear"),
            ("K1 wide glm1000 C=4096", glm1000("glm", 4096), "logistic")]


def _call(ops, family, Xp, y, Z):
    g, gv = ops
    fn = {"floor": gv.floor_cuda, "logistic": g.fused_logistic_vag_cuda,
          "linear": g.fused_linear_vag_cuda}[family]
    return lambda: fn(Xp, y, Z)


def run(against: str | None = None) -> dict:
    packages = {"this": (glm, glm_variants)}
    if against:
        other = module_from(against, "mlx_mcmc_tpu_torch.ops.glm_variants")
        packages["other"] = (other.glm, other)
    sms = sm_count(0)
    out = []
    for label, make, family in _cases():
        Xp, y, Z = make()
        n, d_pad = Xp.shape
        plan = glm.launch_plan(n, d_pad, Z.shape[0], sms, Xp.dtype)
        row = {"case": label, "shape_c_n_dp": [Z.shape[0], n, d_pad], "x_dtype": str(Xp.dtype),
               "plan": {k: v for k, v in plan.items() if not k.endswith("dtype")}}
        calls = {k: _call(ops, family, Xp, y, Z) for k, ops in packages.items()}
        row.update(timed_in_turns(calls))
        if against:
            a, b = calls["this"](), calls["other"]()
            row["bits_equal_to_other"] = all(torch.equal(u, v) for u, v in zip(a, b))
            del a, b
        row["products_library_ms"] = products_yardstick_ms(Xp.to(torch.bfloat16), Z)
        print(f"{label}: plan {row['plan']}", flush=True)
        for key in packages:
            parts = ", ".join(f"{k} {v:.4f}" for k, v in sorted(row["kernels_ms"][key].items()))
            print(f"  {key}: {' '.join(f'{t:.4f}' for t in row['ms'][key])} ms; per kernel: {parts}",
                  flush=True)
        if against:
            print(f"  bits equal to other: {row['bits_equal_to_other']}", flush=True)
        out.append(row)
        del Xp, y, Z, calls
        torch.cuda.empty_cache()
    return {"cases": out}


def main() -> None:
    tool_main(lambda args: run(args.against), "wide_schedule.json")


if __name__ == "__main__":
    main()
