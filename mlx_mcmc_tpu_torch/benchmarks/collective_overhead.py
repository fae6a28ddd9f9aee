"""The marginal cost of the sharded paths' collectives, by subtraction.

Counterpart of the repository's ``benchmarks/collective_overhead.py``
(``measure``): the same total chains, model and HMC at a fixed leapfrog
count (so the integration work is the same in every cell, unlike NUTS,
whose trees follow the adapted step size), timed as

    t(layout, adapt)  for layout in {one process, worlds of N ranks}
                      and adapt in {ON, OFF}

    collective_ms_per_step(N) = [t(N, ON) - t(N, OFF)] - [t(1 process, ON) - t(1 process, OFF)]

The inner differences cancel each layout's integration and dispatch; the
outer one removes the adaptation's arithmetic, leaving its collectives
(one pooled mean a warmup step, two sums of (D,) moments at each window
end; a world of N ranks, ``sample_sharded`` on ``chain_mesh()``, against
``sample()`` in one process). Per-step times come from a two-length slope,
(wall_long - wall_short) / (steps_long - steps_short), which cancels each
call's fixed costs (start, probe, gathers).

A second table prices the data axis: the same HMC at fixed tunables on the
fused logistic GLM, ``sample_sharded`` on ``data_chain_mesh(1, N)`` with
``data_axis='data'`` (each rank holding ``rows`` observations, the prior
outside: ``log_prior_fn``) against ``sample()`` in one process over
``rows`` observations with the prior inside K1's value+grad. Its
``data_ms_per_leapfrog`` is the slope's difference over the leapfrogs a
step: what the data-axis value+grad adds to one evaluation (its
``all_reduce`` of the ``(C, D + 1)`` value and gradient, the buffer around
it and the prior taken apart). ``vs_world_of_one_ms_per_leapfrog`` takes
a world of one as the baseline instead (the collective across ranks).

Layouts: on the CPU one process and gloo worlds of 2 and 4 ranks (a
rehearsal: the ranks share the host's cores); on the card one process and
a world of one, which is all one GPU allows (the output says so).

    python -m mlx_mcmc_tpu_torch.benchmarks.collective_overhead [OUT.json] [--device cpu]
"""

from __future__ import annotations

import json
import math
import sys
import time

import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.benchmarks import card, end_world, run_world, synchronize, worker_group

LEAPFROGS = 16
# The data table's shape (chains, features, rows a rank): glm100_fused's on
# the card, cut on the CPU.
DATA_SHAPE = {"cuda": (4096, 100, 10_000), "cpu": (32, 100, 1_000)}
# The two lengths of warmup steps (the reference's 120 and 420 on the card;
# on the CPU, where a step of 32 chains takes ~30 ms eagerly, 40 and 140).
STEPS = {"cuda": (120, 420), "cpu": (40, 140)}
DATA_STEP_SIZE = 0.01


# what the ranks run with -m (here __name__ may be "__main__")
_MODULE = "mlx_mcmc_tpu_torch.benchmarks.collective_overhead"

def measure(total_chains: int = 32, steps=None, seed: int = 0, layouts=None,
            data_shape=None, device=None) -> dict:
    """The two tables (see the module docstring). ``layouts``: world sizes,
    0 for one process without a process group (default: 0, 2, 4 on the
    CPU; 0 and 1 on the card, whose worlds may not exceed its GPUs)."""
    dev = resolve_device(device)
    limit = torch.cuda.device_count() if dev.type == "cuda" else None
    if layouts is None:
        layouts = (0, 1) if dev.type == "cuda" else (0, 2, 4)
    if limit is not None and max(layouts) > limit:
        raise ValueError(f"a world of {max(layouts)} ranks exceeds the {limit} GPUs here")
    steps = steps or STEPS[dev.type]
    args = dict(total_chains=total_chains, steps=list(steps), seed=seed,
                data_shape=list(data_shape or DATA_SHAPE[dev.type]))
    cells = {}
    for n in layouts:
        t0 = time.perf_counter()
        cells[n] = run_world(_MODULE, max(n, 1), dev.type, dict(args, layout=n))
        print(f"layout {n}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    grid, data = {}, {}
    name = {n: "one process" if n == 0 else f"world of {n}" for n in layouts}
    for n in layouts:
        on, off = cells[n]["chain"]["on_ms_per_step"], cells[n]["chain"]["off_ms_per_step"]
        grid[name[n]] = {"on_ms_per_step": round(on, 4), "off_ms_per_step": round(off, 4),
                         "adapt_delta_ms": round(on - off, 4)}
        data[name[n]] = {"ms_per_step": round(cells[n]["data"]["ms_per_step"], 4),
                         "data_collectives_per_step": cells[n]["data"]["collectives_per_step"]}
    base = grid[name[layouts[0]]]
    for n in layouts[1:]:
        row = grid[name[n]]
        row["collective_ms_per_step"] = round(row["adapt_delta_ms"] - base["adapt_delta_ms"], 4)
        row["sharding_dispatch_ms_per_step"] = round(
            row["off_ms_per_step"] - base["off_ms_per_step"], 4)
        d = data[name[n]]
        d["data_ms_per_leapfrog"] = round(
            (d["ms_per_step"] - data[name[layouts[0]]]["ms_per_step"]) / LEAPFROGS, 4)
        if 1 in layouts and n != 1:
            d["vs_world_of_one_ms_per_leapfrog"] = round(
                (d["ms_per_step"] - data["world of 1"]["ms_per_step"]) / LEAPFROGS, 4)
    chains, features, rows = args["data_shape"]
    return {
        "device": card(dev),
        "layouts": [name[n] for n in layouts],
        "note": ("one GPU: only a world of one runs on the card" if dev.type == "cuda" else
                 "gloo worlds on the CPU: a rehearsal, the ranks share the host's cores"),
        "design": (f"HMC ({LEAPFROGS} leapfrogs), hierarchical normal (100 groups x 10), "
                   f"{total_chains} chains on every layout; ms per step from the slope between "
                   f"{steps[0]} and {steps[1]} warmup steps. collective_ms_per_step = (on - "
                   "off)[world of N] - (on - off)[one process]."),
        "chain_axis": grid,
        "data_design": (f"HMC ({LEAPFROGS} leapfrogs) at a fixed step size {DATA_STEP_SIZE}, "
                        f"fused logistic GLM, {chains} chains, {features} features, {rows} rows "
                        "a rank (bf16 X); data_ms_per_leapfrog = (ms_per_step[world of N, data "
                        f"axis] - ms_per_step[one process]) / {LEAPFROGS}."),
        "data_axis": data,
    }


def _per_step_ms(run, steps, device) -> float:
    """ms a step from two lengths' walls, each after a warm run."""
    walls = {}
    for w in steps:
        run(w)  # warm: the runner, its graphs, the allocator
        synchronize(device)
        t0 = time.perf_counter()
        res = run(w)
        next(iter(res.samples.values())).float().sum().item()
        walls[w] = time.perf_counter() - t0
    return 1e3 * (walls[steps[1]] - walls[steps[0]]) / (steps[1] - steps[0])


def _data_problem(world: int, features: int, rows: int, device):
    from mlx_mcmc_tpu_torch.models import make_logistic_regression
    from mlx_mcmc_tpu_torch.ops.glm import prepare_fused_logistic_data

    spec = make_logistic_regression(num_features=features, num_obs=rows * world, seed=0,
                                    data_dtype=torch.bfloat16, device=device)
    return spec.initial_params, prepare_fused_logistic_data(spec.X, spec.y, num_shards=world,
                                                            device=device)


def unit_normal_prior(params):
    """log N(beta; 0, I) in closed form: the prior that K1's value+grad adds
    in its body, for the data axis to add once after its sum. Tensor ops
    only, so the transition's graphs capture it."""
    beta = params["beta"]
    return -0.5 * torch.sum(beta * beta) - 0.5 * beta.shape[-1] * math.log(2.0 * math.pi)


unit_normal_prior.graph_safe = True


def _worker(argv) -> None:
    from mlx_mcmc_tpu_torch import sample
    from mlx_mcmc_tpu_torch.models import make_hierarchical_normal
    from mlx_mcmc_tpu_torch.ops.glm import make_fused_logistic_vag
    from mlx_mcmc_tpu_torch.parallel import chain_mesh, data_chain_mesh, sample_sharded

    rank, world, device, args, out = worker_group(argv)
    layout, steps, seed = args["layout"], args["steps"], args["seed"]
    spec = make_hierarchical_normal(num_groups=100, obs_per_group=10, seed=0, device=device)

    def chain_run(adapt):
        kw = dict(num_samples=1, num_chains=args["total_chains"], kernel="hmc",
                  num_leapfrog_steps=LEAPFROGS, seed=seed, adapt_step_size=adapt,
                  adapt_mass_matrix=adapt, step_size="auto" if adapt else 0.05, device=device)
        if layout == 0:
            return lambda w: sample(spec.log_prob, spec.initial_params, num_warmup=w, **kw)
        mesh = chain_mesh()
        return lambda w: sample_sharded(spec.log_prob, spec.initial_params, num_warmup=w,
                                        mesh=mesh, **kw)

    chain = {"on_ms_per_step": _per_step_ms(chain_run(True), steps, device),
             "off_ms_per_step": _per_step_ms(chain_run(False), steps, device)}

    chains, features, rows = args["data_shape"]
    kw = dict(num_samples=1, num_chains=chains, kernel="hmc", num_leapfrog_steps=LEAPFROGS,
              seed=seed, step_size=DATA_STEP_SIZE, adapt_step_size=False,
              adapt_mass_matrix=False, device=device)
    counted = []
    if layout == 0:
        init, data = _data_problem(1, features, rows, device)
        vag = make_fused_logistic_vag()

        def data_run(w):
            return sample(None, init, num_warmup=w, data=data, value_and_grad_fn=vag, **kw)
    else:
        init, data = _data_problem(world, features, rows, device)
        vag, mesh = make_fused_logistic_vag(include_prior=False), data_chain_mesh(1, world)

        def data_run(w):
            res = sample_sharded(None, init, num_warmup=w, mesh=mesh, data=data,
                                 data_axis="data", log_prior_fn=unit_normal_prior,
                                 value_and_grad_fn=vag, **kw)
            counted.append((w, res.collectives["data"]["count"]))
            return res
    data_ms = _per_step_ms(data_run, steps, device)
    per_step = None
    if counted:
        (w0, c0), (w1, c1) = counted[0], counted[-1]
        per_step = (c1 - c0) / (w1 - w0)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"chain": chain, "data": {"ms_per_step": data_ms,
                                                "collectives_per_step": per_step}}, f)
    end_world()


def main() -> None:
    if "--worker" in sys.argv:
        _worker(sys.argv[sys.argv.index("--worker") + 1:])
        return
    argv = sys.argv[1:]
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        device, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    blob = json.dumps(measure(device=device), indent=1)
    if argv:
        with open(argv[0], "w") as f:
            f.write(blob)
    print(blob)


if __name__ == "__main__":
    main()
