"""ADVI at glm100's full width in both packages, seed by seed, against the
Laplace approximation: the bands of ``chip_smoke.py``'s phase 7c.

    PYTHONPATH=. JAX_PLATFORMS=cpu python3 tools/glm100_advi_bands.py [STEPS [SEED ...]]
    python3 tools/glm100_advi_bands.py --port-only [STEPS [SEED ...]]

The reference's glm100 problem (its ``bench.py:239-247``: the logistic GLM
over f32 X, 10K observations x 100 features, a unit normal prior) and the
port's (``mlx_mcmc_tpu_torch.bench``'s ``plain_glm_log_prob``, the same
data bit for bit) are fitted with ``fit_advi`` (default 1000 steps, 8 Monte
Carlo draws a step; seeds 0-3 by default): ``method='meanfield'`` at the
default learning rate 0.05, ``'fullrank'`` at 0.05, 0.01 and
``FULLRANK_LR``. One JSON line per package, method, learning rate and
seed: the wall, the final ELBO estimate, and q against the Laplace
approximation on the same X (``chip_smoke.laplace_fit``, float64): max
|mu - MAP| / sd and the range of q's marginal sd over the Laplace sd. The
default imports JAX and the reference package and runs on the CPU;
``--port-only`` runs the port alone on the card.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

import chip_smoke
from mlx_mcmc_tpu_torch import bench, fit_advi

# Full-rank ADVI at the default 0.05 diverges here in both packages (L's
# 5,050 entries each take Adam steps of ~0.05 against marginal sds of
# ~0.2); at 0.01 both settle within 1000 steps at most seeds, at 0.005 at
# every seed tried (chip_smoke.ADVI_FULLRANK_LR).
FULLRANK_LR = chip_smoke.ADVI_FULLRANK_LR
FITS = (("meanfield", 0.05), ("fullrank", 0.05), ("fullrank", 0.01), ("fullrank", FULLRANK_LR))


def _line(package, method, lr, seed, mean, sd, elbo, wall, laplace) -> dict:
    gap, lo, hi = chip_smoke.advi_gap(mean, sd, *laplace)
    return {"package": package, "method": method, "learning_rate": lr, "seed": seed,
            "wall_seconds": wall, "elbo": elbo, "laplace_max_gap_sd": gap,
            "laplace_sd_ratio": [lo, hi]}


def main() -> None:
    args = sys.argv[1:]
    port_only = "--port-only" in args
    args = [a for a in args if a != "--port-only"]
    steps = int(args[0]) if args else 1000
    seeds = [int(a) for a in args[1:]] or [0, 1, 2, 3]
    device = "cuda" if port_only else "cpu"
    log_prob, init, data, _ = bench.build_problem(bench.CONFIGS["glm100"], device=device)
    laplace = chip_smoke.laplace_fit(chip_smoke.plain_data(data))
    if not port_only:
        import jax
        import jax.numpy as jnp

        import mlx_mcmc_tpu as jmm

        def j_log_prob(params, data):
            beta = params["beta"]
            s = jnp.dot(data["X"], beta, preferred_element_type=jnp.float32)
            return jnp.sum(data["y"] * s - jax.nn.softplus(s)) + jnp.sum(
                jmm.Normal(0.0, 1.0).log_prob(beta))

        j_data = {k: jnp.asarray(v.numpy()) for k, v in data.items()}
        j_init = {"beta": jnp.zeros(data["X"].shape[1], jnp.float32)}
    for method, lr in FITS:
        for seed in seeds:
            t0 = time.perf_counter()
            q = fit_advi(log_prob, init, method=method, num_steps=steps, seed=seed, data=data,
                         learning_rate=lr, device=device)
            mean, sd, elbo = q.mu, torch.exp(q.log_sigma), q.elbo
            print(json.dumps(_line("port", method, lr, seed, mean, sd, elbo,
                                   time.perf_counter() - t0, laplace)), flush=True)
            if port_only:
                continue
            t0 = time.perf_counter()
            jq = jmm.fit_advi(j_log_prob, j_init, method=method, num_steps=steps, seed=seed,
                              data=j_data, learning_rate=lr)
            mean = torch.tensor(np.array(jq.mu))
            sd = torch.tensor(np.exp(np.array(jq.log_sigma)))
            print(json.dumps(_line("reference", method, lr, seed, mean, sd, jq.elbo,
                                   time.perf_counter() - t0, laplace)), flush=True)


if __name__ == "__main__":
    main()
