"""ChEES and MALA at glm100_fused's widths in both packages, seed by seed.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/glm100_chees_mala_accept.py [CHAINS WARMUP SAMPLES [SEED ...]]
    python3 tools/glm100_chees_mala_accept.py --port-only [CHAINS WARMUP SAMPLES [SEED ...]]

A rehearsal of ``chip_smoke.py``'s ChEES and MALA phase at a reduced chain
count: the reference's glm100_fused problem (its ``bench.py:196-249``: 100
features, 10K observations, bf16 X; on the CPU its fused value+grad takes
its jnp path) and the port's (``mlx_mcmc_tpu_torch.bench``'s, the same
data bit for bit, K1's plain version) sample with ``kernel="chees"`` and
``kernel="mala"`` at the same settings (default 64 chains, 300 + 200, bf16
store, seed 1; several seeds give the spread of each statistic). One JSON
line per package, kernel and seed: the mean accept statistic (ChEES's
target 0.651, MALA's 0.574), divergences, the final step size and (ChEES)
trajectory length and mean leapfrogs per draw, min ESS per draw (the
port's estimator on either package's draws) and the smoke's Laplace check
(max |mean - MAP| / sd, and the range of the sd ratios) on the same bf16 X.
The default imports JAX and the reference package and runs on the CPU
(a few minutes on 8 cores at 64 chains); ``--port-only`` runs the port
alone on the card, through K1.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke
from mlx_mcmc_tpu_torch import bench, sample
from mlx_mcmc_tpu_torch.diagnostics.device import device_ess


def _line(package, kernel, seed, draws, accept, divergences, step_size, traj, steps, data,
          wall, device):
    beta = torch.as_tensor(np.array(draws, np.float32), device=device)
    ess = device_ess(beta)
    z_gap, sd_lo, sd_hi = chip_smoke.laplace_check(data, beta)
    m, n, _ = beta.shape
    return {
        "package": package, "kernel": kernel, "seed": seed, "chains": m, "draws": n,
        "wall_seconds": wall, "mean_accept": accept, "divergences": divergences,
        "final_step_size": step_size, "trajectory_length": traj, "mean_leapfrogs": steps,
        "min_ess_per_draw": float(ess.min()) / (m * n),
        "laplace_max_gap_sd": z_gap, "laplace_sd_ratio": [sd_lo, sd_hi],
    }


def main() -> None:
    args = sys.argv[1:]
    port_only = "--port-only" in args
    args = [a for a in args if a != "--port-only"]
    chains, warmup, draws = (int(a) for a in (args[:3] if len(args) >= 3 else (64, 300, 200)))
    seeds = [int(a) for a in args[3:]] or [1]
    device = "cuda" if port_only else "cpu"
    cfg = dict(bench.CONFIGS["glm100_fused"], num_chains=chains, num_warmup=warmup,
               num_samples=draws)
    t_lp, t_init, t_data, t_extra = bench.build_problem(cfg, device=device)
    if not port_only:
        import bench as ref_bench
        from mlx_mcmc_tpu import sample as j_sample

        j_lp, j_init, j_data, j_extra = ref_bench.build_problem(
            ref_bench.CONFIGS["glm100_fused"])
    for seed in seeds:
        settings = dict(num_chains=chains, num_warmup=warmup, num_samples=draws, seed=seed,
                        store_dtype="bfloat16")
        for kernel in ("chees", "mala"):
            if not port_only:
                t0 = time.perf_counter()
                res = j_sample(j_lp, j_init, kernel=kernel, data=j_data, **settings, **j_extra)
                beta = np.asarray(res.samples["beta"].astype(np.float32))
                wall = time.perf_counter() - t0
                traj = float(res.tunables.trajectory_length) if kernel == "chees" else None
                print(json.dumps(_line(
                    "reference", kernel, seed, beta,
                    float(np.mean(np.asarray(res.info.accept_prob))),
                    int(np.sum(np.asarray(res.info.is_divergent))), float(res.tunables.step_size),
                    traj, float(np.mean(np.asarray(res.info.num_integration_steps))), t_data,
                    wall, device)), flush=True)
            t0 = time.perf_counter()
            res = sample(t_lp, t_init, kernel=kernel, data=t_data, device=device, **settings,
                         **t_extra)
            beta = res.samples["beta"].float().cpu().numpy()
            wall = time.perf_counter() - t0
            traj = float(res.tunables.trajectory_length) if kernel == "chees" else None
            print(json.dumps(_line(
                "port", kernel, seed, beta, float(res.info.accept_prob.mean()), res.divergences,
                float(res.tunables.step_size), traj,
                float(res.info.num_integration_steps.float().mean()), t_data, wall, device)),
                flush=True)


if __name__ == "__main__":
    main()
