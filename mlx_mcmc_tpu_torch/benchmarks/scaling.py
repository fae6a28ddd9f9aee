"""Weak scaling over the chain axis: min-ESS/s against the number of ranks.

Counterpart of the repository's ``benchmarks/scaling.py``. The chains per
rank stay fixed, so ideal scaling doubles min-ESS/s with every doubling of
ranks; ``efficiency`` is (ESS/s / ESS/s of the first count) / (ranks /
ranks of the first count). Each rank count ``n`` starts a world of ``n``
processes (``benchmarks.run_world``): gloo on the CPU, where it rehearses
the measurement (the ranks share the host's cores, so its numbers say
nothing of a cluster), and nccl on the card, where ``n`` may not exceed
the GPUs there. Each world runs ``sample_sharded`` on ``chain_mesh()``
twice (a warm run, then the timed one) and takes the ESS of every
parameter on the device (``diagnostics.device_ess``) inside the timed
wall.

    python -m mlx_mcmc_tpu_torch.benchmarks.scaling [--shards 1 2 4 8] [--chains-per-shard 8]
        [--num-warmup 200] [--num-samples 200] [--kernel nuts] [--model hier|glm]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Sequence

import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.benchmarks import card, end_world, run_world, synchronize, worker_group


# what the ranks run with -m (here __name__ may be "__main__")
_MODULE = "mlx_mcmc_tpu_torch.benchmarks.scaling"

def rank_limit(device: torch.device) -> int:
    """The most ranks a world may have here: the GPUs on the card, the
    cores on the CPU."""
    return torch.cuda.device_count() if device.type == "cuda" else os.cpu_count() or 1


def measure_scaling(
    shard_counts: Sequence[int],
    *,
    chains_per_shard: int = 8,
    num_warmup: int = 200,
    num_samples: int = 200,
    kernel: str = "nuts",
    seed: int = 0,
    model: str = "hier",
    device=None,
    verbose: bool = False,
) -> List[dict]:
    """The same workload at each rank count; per count its chains, wall,
    min-ESS and ESS/s, then the efficiency against the first. ``model``:
    'hier' (the reference's default, a 100-group non-centered hierarchical
    normal over 10 observations a group) or 'glm' (the 100-parameter
    logistic GLM over 10K observations). ``device=None`` means the card;
    ``'cpu'`` rehearses on gloo."""
    dev = resolve_device(device)
    limit = rank_limit(dev)
    for n in shard_counts:
        if n > limit:
            raise ValueError(f"shard count {n} exceeds {limit} "
                             f"{'GPUs' if dev.type == 'cuda' else 'CPU cores'}")
    args = dict(chains_per_shard=chains_per_shard, num_warmup=num_warmup,
                num_samples=num_samples, kernel=kernel, seed=seed, model=model)
    rows = []
    for n in shard_counts:
        rows.append(run_world(_MODULE, n, dev.type, args))
        if verbose:
            print(rows[-1], flush=True)
    base = rows[0]
    for row in rows:
        ideal = row["shards"] / base["shards"]
        row["efficiency"] = round((row["ess_per_sec"] / base["ess_per_sec"]) / ideal, 3)
    return rows


def _model(name: str, device):
    if name == "glm":
        from mlx_mcmc_tpu_torch.models import make_logistic_regression

        spec = make_logistic_regression(num_features=100, num_obs=10_000, seed=0, device=device)
    else:
        from mlx_mcmc_tpu_torch.models import make_hierarchical_normal

        spec = make_hierarchical_normal(num_groups=100, obs_per_group=10, seed=0, device=device)
    return spec.log_prob, spec.initial_params


def _worker(argv) -> None:
    from mlx_mcmc_tpu_torch.diagnostics.device import device_ess
    from mlx_mcmc_tpu_torch.parallel import chain_mesh, sample_sharded

    rank, world, device, args, out = worker_group(argv)
    log_prob, init = _model(args["model"], device)
    mesh = chain_mesh()
    num_chains = args["chains_per_shard"] * world

    def run(seed):
        return sample_sharded(log_prob, init, num_samples=args["num_samples"],
                              num_warmup=args["num_warmup"], num_chains=num_chains,
                              kernel=args["kernel"], seed=seed, mesh=mesh, device=device)

    def min_ess(res):
        return min(float(device_ess(v.float().reshape(v.shape[0], v.shape[1], -1)).min())
                   for v in res.samples.values())

    min_ess(run(args["seed"]))  # the warm run: captures, allocator, ESS
    synchronize(device)
    t0 = time.perf_counter()
    ess = min_ess(run(args["seed"] + 1))  # reading the ESS waits for the card
    wall = time.perf_counter() - t0
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"shards": world, "num_chains": num_chains, "wall_seconds": round(wall, 3),
                       "min_ess": round(ess, 1), "ess_per_sec": round(ess / wall, 2),
                       "device": card(device)}, f)
    end_world()


def main() -> None:
    if "--worker" in sys.argv:
        _worker(sys.argv[sys.argv.index("--worker") + 1:])
        return
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--shards", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--chains-per-shard", type=int, default=8)
    p.add_argument("--num-warmup", type=int, default=200)
    p.add_argument("--num-samples", type=int, default=200)
    p.add_argument("--kernel", default="nuts")
    p.add_argument("--model", choices=["glm", "hier"], default="hier")
    p.add_argument("--device", default=None)
    args = p.parse_args()
    rows = measure_scaling(args.shards, chains_per_shard=args.chains_per_shard,
                           num_warmup=args.num_warmup, num_samples=args.num_samples,
                           kernel=args.kernel, model=args.model, device=args.device, verbose=True)
    print(f"\n{'shards':>7} {'chains':>7} {'wall(s)':>9} {'min-ESS/s':>11} {'efficiency':>11}")
    for r in rows:
        print(f"{r['shards']:>7} {r['num_chains']:>7} {r['wall_seconds']:>9.2f} "
              f"{r['ess_per_sec']:>11.1f} {r['efficiency']:>11.3f}")
    print(json.dumps({"rows": rows}))


if __name__ == "__main__":
    main()
