"""Where a NUTS leapfrog's time goes, at glm100_fused's shape on the card.

Counterpart of the repository's ``benchmarks/nuts_overhead.py``: 4096 chains
x 100 parameters over 10K observations, bf16 X through K1
(``ops/glm.py``), depth cap 6, at a fixed step size (0.18) and unit metric:

  A. a leapfrog loop (one leapfrog captured as a CUDA graph and replayed
     ``T_A`` times): value+grad and integrator cost a leapfrog;
  B. ``T_B`` full NUTS transitions as ``sample()`` runs them (the engine's
     Philox momenta and uniform tables a step, the transition's CUDA
     graphs, one host check a pair iteration): cost per executed leapfrog
     (``1 + 2 * max over chains of ceil((leaves - 1) / 2)`` a transition,
     ``bench.lockstep_leaves``) and per pair iteration;
  C. one NUTS step of the same shape around a near-free value+grad
     (``bench.nuts_loop_costs``): the loop's own cost a pair iteration,
     eager and through graphs.

B - A is the bookkeeping a leaf pays beyond its leapfrog. Times come from
CUDA events. ``flagship_breakdown`` multiplies its executed leaves by B's
cost a leaf.

    python -m mlx_mcmc_tpu_torch.benchmarks.nuts_overhead [--device cpu]
"""

from __future__ import annotations

import json

import torch

from mlx_mcmc_tpu_torch import bench
from mlx_mcmc_tpu_torch.benchmarks import card, device_from_argv, elapsed_ms
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.inference.engine import make_kernel, step_inputs
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.integrators import IntegratorState, leapfrog

C, D, N, MAX_DEPTH = 4096, 100, 10_000, 6
T_A, T_B = 512, 64
STEP_SIZE = 0.18


def glm_problem(device, chains: int = C, dim: int = D, num_obs: int = N):
    """glm100_fused's data and fused value+grad at the given shape, and
    the value+grad bound to the data (graph-safe as K1's)."""
    cfg = dict(bench.CONFIGS["glm100_fused"], num_chains=chains, num_features=dim,
               num_obs=num_obs)
    _, init, data, extra = bench.build_problem(cfg, device)
    fused = extra["value_and_grad_fn"]

    def vag(Z):
        return fused(Z, data)

    vag.graph_safe = graphs.captures(fused)
    return cfg, init, data, fused, vag


def leapfrog_ms(vag, Z0, tunables, steps: int) -> float:
    """A: ms a leapfrog over ``steps`` leapfrogs from ``Z0``; on the card
    one leapfrog is a captured graph replayed ``steps`` times."""
    lp, g = vag(Z0)
    state = IntegratorState(Z0.clone(), 0.01 * Z0, lp.clone(), g.clone())

    def one():
        new = leapfrog(state, tunables.step_size, tunables.inv_mass_diag, vag)
        for buf, value in zip(state, new):
            buf.copy_(value)

    device = Z0.device
    if device.type == "cuda" and graphs.captures(vag):
        with graphs.side_stream(device):
            one()  # the warm-up a capture needs
        graph, _ = graphs.capture(one)
        step = graph.replay
    else:
        step = one
    step()
    _, ms = elapsed_ms(lambda: [step() for _ in range(steps)], device)
    return ms / steps


def nuts_steps(vag, Z0, tunables, depth: int, steps: int, seed: int = 0):
    """B: ``steps`` NUTS transitions from ``Z0`` as the engine runs them.
    Returns ``(ms, (steps, C) leaf counts, pair iterations run)``."""
    device = Z0.device
    init_fn, step_fn = make_kernel("nuts", vag, max_tree_depth=depth)
    transition = None
    if device.type == "cuda" and graphs.captures(vag):
        transition = graphs.GraphedTransition(vag, max_tree_depth=depth)
        step_fn = transition.step
    chains = torch.arange(Z0.shape[0], device=device)
    n_slots = 1 << (depth - 1)
    start = init_fn(Z0)
    step_fn(start, tunables, *step_inputs(seed, chains, 0, tunables.inv_mass_diag, n_slots))

    def run():
        state, counts, pairs = start, [], 0
        for t in range(steps):
            r0, U = step_inputs(seed, chains, t, tunables.inv_mass_diag, n_slots)
            state, info, syncs = step_fn(state, tunables, r0, U)
            counts.append(info.num_integration_steps.clone())
            pairs += syncs - 1  # a host check after the root, then one a pair iteration
        return torch.stack(counts), pairs

    (counts, pairs), ms = elapsed_ms(run, device)
    return ms, counts, pairs


def measure(device, chains: int = C, dim: int = D, num_obs: int = N, depth: int = MAX_DEPTH,
            t_a: int = T_A, t_b: int = T_B, problem=None) -> dict:
    """A, B and C at the given shape (the reference's by default);
    ``problem`` is :func:`glm_problem`'s at that shape, made if None."""
    _, _, _, _, vag = problem or glm_problem(device, chains, dim, num_obs)
    gen = torch.Generator(device=device).manual_seed(0)
    Z0 = 0.05 * torch.randn(chains, dim, generator=gen, device=device)
    tun = Tunables(torch.tensor(STEP_SIZE, device=device), torch.ones(dim, device=device))
    report = {"shape": {"chains": chains, "dim": dim, "num_obs": num_obs, "max_tree_depth": depth},
              "step_size": STEP_SIZE, "pairs_per_replay": graphs.PAIRS_PER_REPLAY}
    report["A_leapfrog_ms"] = leapfrog_ms(vag, Z0, tun, t_a)

    ms, counts, pairs = nuts_steps(vag, Z0, tun, depth, t_b)
    steps = counts.double()  # (T, C)
    executed = float(bench.lockstep_leaves(steps.T).sum())
    useful = float(steps.mean(dim=1).sum())
    lockstep = float(steps.amax(dim=1).sum())
    report.update(
        B_wall_s=ms / 1e3,
        B_steps=t_b,
        B_leaves_lockstep=int(lockstep),
        B_leaves_executed=int(executed),
        B_pair_iterations=pairs,
        B_mean_leaves_per_draw=float(steps.mean()),
        B_max_leaves_per_draw=float(steps.amax(dim=1).mean()),
        B_per_leaf_ms=ms / executed,
        B_per_pair_iteration_ms=ms / max(pairs, 1),
        B_per_useful_leaf_ms=ms / useful,
        B_lockstep_tax=executed / useful,
    )

    r0, U = step_inputs(0, torch.arange(chains, device=device), 0, tun.inv_mass_diag,
                        1 << (depth - 1))
    report.update(bench.nuts_loop_costs("C", bench._elementwise_vag, Z0, tun, r0, U, depth))
    report["implied_bookkeeping_ms"] = report["B_per_leaf_ms"] - report["A_leapfrog_ms"]
    return report


def main() -> None:
    device = device_from_argv()
    smi = card(device)
    print(smi, flush=True)
    print(json.dumps(dict(measure(device), device=smi)), flush=True)


if __name__ == "__main__":
    main()
