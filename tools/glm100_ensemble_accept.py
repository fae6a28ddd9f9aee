"""The ensemble sampler at glm100_fused's data in both packages, seed by seed.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/glm100_ensemble_accept.py [WALKERS WARMUP SAMPLES [SEED ...]]

Sets ``chip_smoke.ENSEMBLE_ACCEPT_BAND`` (at the smoke's 4096 walkers:
``... glm100_ensemble_accept.py 4096 300 2000 0``, ~20 min a package on 8
cores; the walker count moves the mean accept): the reference's glm100_fused
problem (its ``bench.py:196-249``: 100 features, 10K observations, bf16 X)
sampled by its ``sample_ensemble`` on the bench's value path, and the
port's (``mlx_mcmc_tpu_torch.bench``: the same data bit for bit,
``bench.fused_glm_value_log_prob``) by the port's, at the same settings
(default 512 walkers, 300 + 2000, seeds 0-3). One JSON line per package
and seed: the mean accept statistic, the accepted share, the wall and the
min ESS per draw (the port's estimator on either package's draws). Both
run on the CPU (a few minutes a seed on 8 cores at 512 walkers).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from mlx_mcmc_tpu_torch import bench, sample_ensemble
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size


def _line(package, seed, beta, accept_prob, accepted, wall):
    ess = effective_sample_size(np.asarray(beta, np.float32))
    m, n, _ = beta.shape
    return {"package": package, "seed": seed, "walkers": m, "draws": n, "wall_seconds": wall,
            "mean_accept": float(np.mean(accept_prob)), "accepted_share": float(np.mean(accepted)),
            "min_ess_per_draw": float(ess.min()) / (m * n)}


def main() -> None:
    args = sys.argv[1:]
    walkers, warmup, draws = (int(a) for a in (args[:3] if len(args) >= 3 else (512, 300, 2000)))
    seeds = [int(a) for a in args[3:]] or [0, 1, 2, 3]
    import bench as ref_bench
    from mlx_mcmc_tpu import sample_ensemble as j_sample_ensemble

    j_lp, j_init, j_data, _ = ref_bench.build_problem(ref_bench.CONFIGS["glm100_fused"])
    cfg = dict(bench.CONFIGS["glm100_fused"])
    _, t_init, t_data, _ = bench.build_problem(cfg, device="cpu")
    settings = dict(num_walkers=walkers, num_warmup=warmup, num_samples=draws)
    for seed in seeds:
        t0 = time.perf_counter()
        res = j_sample_ensemble(j_lp, j_init, seed=seed, data=j_data, **settings)
        beta = np.asarray(res.samples["beta"], np.float32)
        print(json.dumps(_line("reference", seed, beta, np.asarray(res.info.accept_prob),
                               np.asarray(res.info.is_accepted), time.perf_counter() - t0)),
              flush=True)
        t0 = time.perf_counter()
        res = sample_ensemble(bench.fused_glm_value_log_prob, t_init, seed=seed, data=t_data,
                              device="cpu", **settings)
        print(json.dumps(_line("port", seed, res.samples["beta"].numpy(),
                               res.info.accept_prob.numpy(), res.info.is_accepted.numpy(),
                               time.perf_counter() - t0)), flush=True)


if __name__ == "__main__":
    main()
