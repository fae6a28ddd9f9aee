"""The scaling artifact: the card's chain-count table beside the mesh
rehearsal and the collectives' cost.

Counterpart of the repository's ``benchmarks/make_scaling_artifact.py``.
Three parts, each labelled with where it ran:

1. ``chain_scaling``: glm100_fused on the card at 1,024, 2,048, 4,096 and
   8,192 chains, 500 draws, thin 1 and the bf16 draw store, each row one
   ``python -m mlx_mcmc_tpu_torch.bench`` process (``BENCH_CONFIG``,
   ``BENCH_CHAINS``, ``BENCH_SAMPLES``, ``BENCH_THIN``,
   ``BENCH_SKIP_FUNNEL``); ``efficiency_vs_1024`` is (ESS/s / ESS/s at
   1,024) / (chains / 1,024).
2. ``weak_scaling``: ``benchmarks.scaling`` over 1, 2, 4 and 8 gloo ranks
   on the CPU, a rehearsal of the measurement and no scaling claim (the
   ranks share the host's cores).
3. ``collective_overhead``: ``benchmarks.collective_overhead`` on the card
   (one process against a world of one).

The artifact goes to the path given (default
``build/mlx_mcmc_tpu_torch/results/scaling.json``); the repository's
``SCALING_r0*.json`` files are the reference's and stay as they are.

    python -m mlx_mcmc_tpu_torch.benchmarks.make_scaling_artifact [OUT.json]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from mlx_mcmc_tpu_torch.benchmarks import card

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(REPO, "build", "mlx_mcmc_tpu_torch", "results", "scaling.json")
# (chains, draws, thin), the reference's rows
CHAIN_ROWS = [(1024, 500, 1), (2048, 500, 1), (4096, 500, 1), (8192, 500, 1)]
WEAK_SHARDS = [1, 2, 4, 8]


def chain_row(stdout: str, chains: int, num_samples: int, thin: int) -> dict:
    """A ``chain_scaling`` row from a bench process's output (its last JSON
    line)."""
    line = [ln for ln in stdout.splitlines() if ln.startswith("{")][-1]
    rec = json.loads(line)
    d = rec["detail"]
    return {"num_chains": chains, "num_samples": num_samples, "thin": thin,
            "min_ess_per_sec": rec["value"], "wall_seconds": d["wall_seconds"],
            "min_ess": d["min_ess"], "divergences": d["divergences"],
            "mfu_pct": d.get("roofline", {}).get("mfu_pct")}


def run_chain_row(chains: int, num_samples: int, thin: int) -> dict:
    env = dict(os.environ, BENCH_CONFIG="glm100_fused", BENCH_CHAINS=str(chains),
               BENCH_SAMPLES=str(num_samples), BENCH_THIN=str(thin), BENCH_SKIP_FUNNEL="1")
    out = subprocess.run([sys.executable, "-m", "mlx_mcmc_tpu_torch.bench"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=3600)
    if out.returncode != 0:
        raise RuntimeError(f"bench row chains={chains} failed (exit {out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    return chain_row(out.stdout, chains, num_samples, thin)


def artifact(chain_rows: list, device: str, weak_rows: list, collective: dict) -> dict:
    """The artifact from its three parts' measurements."""
    base = chain_rows[0] if chain_rows else None
    for row in chain_rows:
        ideal = row["num_chains"] / base["num_chains"]
        row["efficiency_vs_1024"] = round((row["min_ess_per_sec"] / base["min_ess_per_sec"])
                                          / ideal, 3)
    return {
        "chain_scaling": {
            "config": "glm100_fused (NUTS, 100-param logistic GLM, 10K obs, bf16 X through "
                      "K1, max_tree_depth=6, bf16 draw store)",
            "device": device,
            "note": "one GPU; ESS on the device; efficiency is (essps/essps_1024)/(chains/1024)",
            "rows": chain_rows,
        },
        "weak_scaling": {
            "config": "hier100 non-centered hierarchical, NUTS, 8 chains a rank, ranks "
                      + "/".join(map(str, WEAK_SHARDS)),
            "device": "gloo worlds on the CPU (a rehearsal: the harness, the collectives and "
                      "the chain split are the multi-GPU path's, the numbers are not a "
                      "cluster's)",
            "efficiency_caveat": "the ranks share the host's cores, so the efficiency column "
                                 "measures contention for them, not the collectives; their "
                                 "cost is in collective_overhead",
            "rows": weak_rows,
        },
        "collective_overhead": collective,
    }


def main() -> None:
    from mlx_mcmc_tpu_torch.benchmarks.collective_overhead import measure
    from mlx_mcmc_tpu_torch.benchmarks.scaling import measure_scaling

    out_path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT
    device = card(torch.device("cuda"))
    chain_rows = []
    for chains, num_samples, thin in CHAIN_ROWS:
        chain_rows.append(run_chain_row(chains, num_samples, thin))
        print(chain_rows[-1], flush=True)
    weak = measure_scaling(WEAK_SHARDS, chains_per_shard=8, num_warmup=200, num_samples=200,
                           kernel="nuts", device="cpu")
    print(weak, flush=True)
    collective = measure()
    blob = artifact(chain_rows, device, weak, collective)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(blob, f, indent=1)
    print(json.dumps(blob))
    print("wrote", out_path)


if __name__ == "__main__":
    main()
