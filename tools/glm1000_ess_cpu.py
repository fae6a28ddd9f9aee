"""ESS per draw of the plain glm1000 path in both packages, on the CPU.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/glm1000_ess_cpu.py [CHAINS WARMUP SAMPLES]

The reference's ``bench.py`` records glm1000_fused at 62,795 min-ESS/s in
8.17 s (256 chains x 400 draws); the port's min-ESS there is ~152K. This
script runs the reference's plain glm1000 model (f32 X, autograd; its
``bench.py:240-248``) and the port's (``mlx_mcmc_tpu_torch.bench``'s
``glm1000``) on the reference's own dataset (100K x 1000) with the same
settings, cut to a few chains and steps (default 8 chains, 200 + 200, depth
8, target 0.8), and prints one JSON line per package: min and median ESS per
draw (each package's device ESS on its own draws, and the other package's
ESS on the same draws), the final step size, mean tree depth and accept,
and the ESS estimator's cap ``m n log10(m n)`` (Stan's), which the
reference's device ESS clamps to. Then a line with the record's implied
min-ESS beside the cap at 256 x 400. Outside the port (it imports JAX and
the reference package); about 10 minutes on 8 cores.
"""

from __future__ import annotations

import json
import math
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

import bench as ref_bench
from mlx_mcmc_tpu import sample as j_sample
from mlx_mcmc_tpu.diagnostics.device import device_ess as j_device_ess
from mlx_mcmc_tpu_torch import bench, sample
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess


def _cap(m: int, n: int) -> float:
    return m * n * math.log10(max(m * n, 10))


def _ess_pair(draws: np.ndarray) -> tuple:
    """(port ESS, reference ESS) of (chains, draws, P) float32 draws."""
    port = device_ess(torch.from_numpy(np.array(draws))).numpy()
    ref = np.asarray(jax.jit(j_device_ess)(jnp.asarray(draws)))
    return port, ref


def _line(name, draws, step_size, depth, accept, wall):
    m, n, _ = draws.shape
    port, ref = _ess_pair(draws)
    return {
        "package": name, "chains": m, "draws": n, "wall_seconds": wall,
        "min_ess_per_draw_port_estimator": float(port.min()) / (m * n),
        "median_ess_per_draw_port_estimator": float(np.median(port)) / (m * n),
        "min_ess_per_draw_reference_estimator": float(ref.min()) / (m * n),
        "median_ess_per_draw_reference_estimator": float(np.median(ref)) / (m * n),
        "params_at_cap": int((ref >= 0.999 * _cap(m, n)).sum()),
        "final_step_size": step_size, "mean_tree_depth": depth, "mean_accept": accept,
        "ess_cap_per_draw": math.log10(m * n),
    }


def main() -> None:
    chains, warmup, samples = (int(a) for a in (sys.argv[1:4] if len(sys.argv) > 3 else (8, 200, 200)))
    run = dict(num_chains=chains, num_warmup=warmup, num_samples=samples, max_tree_depth=8,
               target_accept=0.8, kernel="nuts")

    cfg = dict(ref_bench.CONFIGS["glm1000"])
    log_prob, init, data, extra = ref_bench.build_problem(cfg)
    t0 = time.perf_counter()
    res = j_sample(log_prob, init, data=data, seed=1, **run, **extra)
    draws = np.asarray(res.samples["beta"], np.float32)
    wall = time.perf_counter() - t0
    print(json.dumps(_line("reference", draws, float(res.tunables.step_size),
                           float(np.mean(np.asarray(res.info.tree_depth))),
                           float(np.mean(np.asarray(res.info.accept_prob))), wall)), flush=True)
    del log_prob, data, res

    pcfg = dict(bench.CONFIGS["glm1000"])
    log_prob, init, data, extra = bench.build_problem(pcfg, device="cpu")
    t0 = time.perf_counter()
    res = sample(log_prob, init, data=data, seed=1, device="cpu", **run, **extra)
    draws = res.samples["beta"].float().numpy()
    wall = time.perf_counter() - t0
    print(json.dumps(_line("port", draws, float(res.tunables.step_size),
                           float(res.info.tree_depth.float().mean()), res.acceptance_rate, wall)),
          flush=True)
    record = 62_795 * 8.17
    print(json.dumps({"record_min_ess": record, "record_wall_range": [8.165, 8.175],
                      "record_min_ess_range": [62_795 * 8.165, 62_795 * 8.175],
                      "cap_256x400": _cap(256, 400)}), flush=True)


if __name__ == "__main__":
    main()
