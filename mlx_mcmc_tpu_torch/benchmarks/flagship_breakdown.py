"""Where does the flagship's wall go? Warmup against sampling, and the
lockstep tax, on the card.

Counterpart of the repository's ``benchmarks/flagship_breakdown.py``: the
glm100_fused flagship (4096 chains x 100 parameters over 10K observations,
bf16 X through K1, depth cap 6, target 0.8) at 300 warmup steps + 1000
draws, through ``build_sampler(..., collect_warmup=True)``, so that both
phases' per-chain leaf counts (``num_integration_steps``, ``(W, C)`` and
``(S, C)``) come back. For each phase:

  - executed leaves (``lockstep_leaves``): what the batched loop runs, the
    root and two leaves a pair iteration until the last chain's tree ends,
    ``1 + 2 * max over chains of ceil((leaves - 1) / 2)`` a draw;
  - useful leaves (the chains' mean leaves a draw, summed): what the ESS
    is paid for;
  - the lockstep tax (their ratio);
  - the wall those leaves imply at the cost of an executed leaf that
    ``nuts_overhead`` measures (its B), in the same process at this shape.

A warm run captures the graphs; the timed run's wall includes fetching the
two count arrays to the host.

    python -m mlx_mcmc_tpu_torch.benchmarks.flagship_breakdown [--device cpu] [OUT.json]
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from mlx_mcmc_tpu_torch.bench import lockstep_leaves
from mlx_mcmc_tpu_torch.benchmarks import card, device_from_argv, elapsed_ms, nuts_overhead
from mlx_mcmc_tpu_torch.inference.engine import build_sampler
from mlx_mcmc_tpu_torch.ops.ravel import ravel_params

C, D, N = 4096, 100, 10_000
W, S = 300, 1000
MAX_DEPTH = 6


def phase(steps: np.ndarray, per_leaf_ms: float) -> dict:
    """One phase's leaves from its ``(draws, chains)`` leaf counts, and the
    wall its executed leaves imply at ``per_leaf_ms``."""
    steps = np.asarray(steps, np.float64)
    lockstep = float(lockstep_leaves(torch.from_numpy(steps.T)).sum())
    useful = float(steps.mean(axis=1).sum())
    return {
        "lockstep_leaves": int(lockstep),
        "useful_leaves": int(useful),
        "lockstep_tax": round(lockstep / useful, 3),
        "mean_leaves_per_draw": round(float(steps.mean(axis=1).mean()), 2),
        "max_leaves_per_draw": round(float(steps.max(axis=1).mean()), 2),
        "implied_wall_s": round(lockstep * per_leaf_ms / 1e3, 2),
    }


def run(device, chains: int = C, dim: int = D, num_obs: int = N, num_warmup: int = W,
        num_samples: int = S, depth: int = MAX_DEPTH, overhead_steps=None) -> dict:
    """The breakdown at the given shape (the reference's by default).
    ``overhead_steps``: ``(t_a, t_b)`` for ``nuts_overhead.measure``
    (its defaults if None)."""
    problem = nuts_overhead.glm_problem(device, chains, dim, num_obs)
    cfg, init, data, fused, _ = problem
    t_a, t_b = overhead_steps or (nuts_overhead.T_A, nuts_overhead.T_B)
    overhead = nuts_overhead.measure(device, chains, dim, num_obs, depth, t_a, t_b, problem)
    per_leaf_ms = overhead["B_per_leaf_ms"]

    sampler = build_sampler(None, dim, kernel="nuts", num_warmup=num_warmup,
                            num_samples=num_samples, target_accept=cfg["target_accept"],
                            max_tree_depth=depth, value_and_grad_fn=fused, collect_warmup=True)
    z0, _ = ravel_params(init, device=device)
    z0 = z0.expand(chains, dim).contiguous()

    def timed():
        result, (_, w_infos) = sampler(1, z0, data)
        w_steps = w_infos.num_integration_steps.cpu().numpy()  # (W, C)
        s_steps = result.info.num_integration_steps.T.cpu().numpy()  # (S, C)
        return result, w_steps, s_steps

    timed()  # warm: captures the transition's graphs
    (result, w_steps, s_steps), ms = elapsed_ms(timed, device)
    report = {
        "shape": {"chains": chains, "dim": dim, "num_obs": num_obs, "num_warmup": num_warmup,
                  "num_samples": num_samples, "max_tree_depth": depth},
        "wall_s_with_warmup_collect": round(ms / 1e3, 2),
        "host_syncs": result.host_syncs,
        "graph_replays": result.graph_replays,
        "per_leaf_ms": per_leaf_ms,
        "per_leaf_ms_source": "nuts_overhead B, measured in this process at this shape",
        "warmup": phase(w_steps, per_leaf_ms),
        "sampling": phase(s_steps, per_leaf_ms),
    }
    total = report["warmup"]["lockstep_leaves"] + report["sampling"]["lockstep_leaves"]
    report["total_lockstep_leaves"] = total
    report["implied_nuts_wall_s"] = round(total * per_leaf_ms / 1e3, 2)
    report["nuts_overhead"] = overhead
    report["note"] = (
        "implied_wall = executed leaves x the cost of an executed leaf in full NUTS "
        "transitions through the port's graphs (nuts_overhead B: K1 plus the pair loop's "
        "bookkeeping and its host check); the rest of the measured wall is the per-step "
        "eager work outside the graphs (Philox, adaptation, the draw store)"
    )
    return report


def main() -> None:
    device = device_from_argv()
    smi = card(device)
    print(smi, flush=True)
    blob = json.dumps(dict(run(device), device=smi))
    print(blob, flush=True)
    paths = [a for a in sys.argv[1:] if a.endswith(".json")]
    if paths:
        with open(paths[0], "w") as f:
            f.write(blob)


if __name__ == "__main__":
    main()
