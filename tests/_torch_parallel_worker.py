"""One rank of the port's multi-rank tests: a gloo world on the CPU.

    python tests/_torch_parallel_worker.py RANK WORLD PORT,ENV_PORT OUTDIR SUITE

Started by :class:`Ranks` (``tests/test_torch_parallel.py``,
``tests/test_torch_distributed.py``; the four-rank suites ``data`` and
``resume`` of ``tests/_torch_sharding_worker.py`` for
``tests/test_torch_data_sharding.py`` and
``tests/test_torch_sharded_resume.py``), one process a rank, with the repo
root on ``PYTHONPATH``. The rank joins the world through
``initialize_distributed`` over localhost TCP at PORT (ENV_PORT: the
``init`` suite's second start, from torchrun's variables), runs SUITE's scenarios in
order and writes each one's results to ``OUTDIR/<scenario>.rank<RANK>.npz``
(arrays, and a JSON string under ``"meta"``). Every rank writes its own
copy: each must hold the same global result. The scenarios' settings and
models live here so that the tests can run the same ones in one process.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def normal_model(params):
    from mlx_mcmc_tpu_torch import Normal

    return torch.sum(Normal(1.0, 2.0).log_prob(params["x"]))


def std_normal(params):
    from mlx_mcmc_tpu_torch import Normal

    return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))


Y = np.random.default_rng(42).normal(5.0, 2.0, 100).astype(np.float32)


def facade_model(params):
    from mlx_mcmc_tpu_torch import HalfNormal, Normal

    mu, sigma = params["mu"], params["sigma"]
    return (Normal(0.0, 10.0).log_prob(mu) + HalfNormal(5.0).log_prob(sigma)
            + torch.sum(Normal(mu, sigma).log_prob(torch.from_numpy(Y))))


_FIXED = dict(adapt_step_size=False, adapt_mass_matrix=False, device="cpu")
# Fixed tunables, each kernel at the reference's own settings where it has
# them (tests/test_parallel.py:40-75, tests/test_mala.py:144).
FIXED = {
    "nuts": (normal_model, 2, dict(num_samples=100, num_warmup=50, num_chains=8, kernel="nuts",
                                   seed=0, step_size=0.5, **_FIXED)),
    "hmc": (normal_model, 2, dict(num_samples=50, num_warmup=20, num_chains=8, kernel="hmc",
                                  seed=3, step_size=0.3, **_FIXED)),
    "mala": (std_normal, 2, dict(num_samples=100, num_warmup=100, num_chains=8, kernel="mala",
                                 seed=11, step_size=0.5, **_FIXED)),
    "metropolis": (normal_model, 2, dict(num_samples=60, num_warmup=20, num_chains=8,
                                         kernel="metropolis", seed=5, step_size=0.8, **_FIXED)),
}
# Jittered starts (each chain's own normals) at fixed tunables.
JITTER = dict(num_samples=3, num_warmup=0, num_chains=8, kernel="hmc", seed=7, step_size=0.3,
              jitter=0.5, **_FIXED)
# The plain K1 twin (fused logistic value+grad) at a small width.
GLM = dict(num_features=8, num_obs=256)
GLM_RUN = dict(num_samples=20, num_warmup=10, num_chains=8, kernel="nuts", seed=2,
               step_size=0.1, max_tree_depth=5, **_FIXED)
# Adaptive NUTS with device diagnostics, cut from the reference's sizes
# (tests/test_parallel.py:26-37 and 77-102, tests/test_diagnostics.py:187:
# 500 + 1000, 300 + 100, 300 + 500, depth 10) to 150 + 300 at the bench's
# depth 6: at depth 10 a few early warmup trees run 8x longer on the CPU.
# The full sizes run under -m slow.
ADAPTIVE = dict(num_samples=300, num_warmup=150, num_chains=8, kernel="nuts", seed=0,
                max_tree_depth=6, device="cpu")
ADAPTIVE_REF = {
    "recovery": (normal_model, 3, dict(num_samples=1000, num_warmup=500, num_chains=8,
                                       kernel="nuts", seed=0, device="cpu")),
    "tunables": (normal_model, 2, dict(num_samples=100, num_warmup=300, num_chains=8,
                                       kernel="nuts", seed=0, device="cpu")),
    "vs_sample": (normal_model, 2, dict(num_samples=1000, num_warmup=500, num_chains=8,
                                        kernel="nuts", seed=0, device="cpu")),
    "diagnostics": (std_normal, 3, dict(num_samples=500, num_warmup=300, num_chains=8,
                                        kernel="nuts", seed=0, device="cpu",
                                        device_diagnostics=True)),
}
# tests/test_chees.py:114, cut from 500 + 500 (full under -m slow).
CHEES = dict(num_samples=200, num_warmup=200, num_chains=8, kernel="chees", seed=0, device="cpu")
CHEES_REF = dict(CHEES, num_samples=500, num_warmup=500)
# tests/test_facade.py:150-172: NUTS cut from 300 + 300 (full under -m
# slow), Metropolis at its sizes.
FACADE = {"nuts": dict(num_samples=100, num_warmup=100), "metropolis": dict(num_samples=300,
                                                                             num_warmup=300)}
FACADE_REF = {"nuts": dict(num_samples=300, num_warmup=300)}
CHUNK = dict(FIXED["hmc"][2], draw_chunk=16)
# Seeded inputs of the pooled statistics: each rank's block of 8 chains.
STATS_CHAINS, STATS_DRAWS, STATS_DIM = 8, 200, 3


def stats_inputs():
    """The pooled statistics' inputs: every rank's Welford state (count,
    mean (D,), m2 (D,)) and the draws ``(chains, draws, D)``, float32."""
    rng = np.random.default_rng(123)
    world = 2
    count = rng.integers(50, 200, size=world).astype(np.float32)
    mean = rng.normal(size=(world, STATS_DIM)).astype(np.float32)
    m2 = (rng.gamma(2.0, size=(world, STATS_DIM)) * count[:, None]).astype(np.float32)
    ar = np.zeros((STATS_CHAINS, STATS_DRAWS, STATS_DIM), np.float32)
    noise = rng.normal(size=ar.shape).astype(np.float32)
    for t in range(1, STATS_DRAWS):  # AR(1) chains with per-chain offsets
        ar[:, t] = 0.7 * ar[:, t - 1] + noise[:, t]
    ar += 0.1 * rng.normal(size=(STATS_CHAINS, 1, STATS_DIM)).astype(np.float32)
    return count, mean, m2, ar


def glm_problem():
    from mlx_mcmc_tpu_torch.models import make_logistic_regression
    from mlx_mcmc_tpu_torch.ops.glm import make_fused_logistic_vag, prepare_fused_logistic_data

    spec = make_logistic_regression(seed=0, data_dtype=torch.bfloat16, device="cpu", **GLM)
    data = prepare_fused_logistic_data(spec.X, spec.y, device="cpu")
    return spec.initial_params, data, make_fused_logistic_vag(1.0)


def result_arrays(res) -> dict:
    """A result's draws and info fields as float64/int numpy arrays."""
    out = {f"s_{k}": np.asarray(v if isinstance(v, np.ndarray) else v.float().numpy())
           for k, v in res.samples.items()}
    for field, x in zip(type(res.info)._fields, res.info):
        out[f"i_{field}"] = np.asarray(x) if isinstance(x, np.ndarray) else x.numpy()
    return out


def _scenarios(rank: int, world: int, outdir: str) -> dict:
    import torch.distributed as dist

    from mlx_mcmc_tpu_torch import MCMC
    from mlx_mcmc_tpu_torch.diagnostics.device import device_ess, device_rhat
    from mlx_mcmc_tpu_torch.inference.engine import jittered_starts
    from mlx_mcmc_tpu_torch.io import load_checkpoint, resume, save_checkpoint
    from mlx_mcmc_tpu_torch.ops.math import WelfordState, welford_psum_merge
    from mlx_mcmc_tpu_torch.parallel import sample_sharded
    from mlx_mcmc_tpu_torch.parallel.distributed import Collectives

    def fixed():
        out = {}
        for name, (model, dim, kw) in FIXED.items():
            res = sample_sharded(model, {"x": torch.zeros(dim)}, **kw)
            out.update({f"{name}_{k}": v for k, v in result_arrays(res).items()})
        return out, {}

    def jitter():
        res = sample_sharded(normal_model, {"x": torch.zeros(2)}, **JITTER)
        local = JITTER["num_chains"] // world
        starts = jittered_starts(JITTER["seed"], torch.zeros(local, 2), JITTER["jitter"],
                                 first_chain=rank * local)
        return dict(result_arrays(res), starts=starts.numpy()), {}

    def glm():
        init, data, vag = glm_problem()
        res = sample_sharded(None, init, data=data, value_and_grad_fn=vag, **GLM_RUN)
        return result_arrays(res), {}

    def stats():
        count, mean, m2, ar = stats_inputs()
        pool = Collectives(dist.group.WORLD)
        w = welford_psum_merge(WelfordState(torch.tensor(count[rank]), torch.tensor(mean[rank]),
                                            torch.tensor(m2[rank])), pool.psum)
        local = STATS_CHAINS // world
        block = torch.from_numpy(ar[rank * local:(rank + 1) * local])
        rhat = device_rhat(block, dist.group.WORLD)
        ess = device_ess(block, pool)
        return dict(count=w.count.numpy(), mean=w.mean.numpy(), m2=w.m2.numpy(),
                    rhat=rhat.numpy(), ess=ess.numpy()), {"collectives": pool.count}

    def adaptive():
        res = sample_sharded(normal_model, {"x": torch.zeros(3)}, device_diagnostics=True,
                             **ADAPTIVE)
        arrays = dict(result_arrays(res), inv_mass=res.tunables.inv_mass_diag.numpy(),
                      step_size=res.tunables.step_size.numpy(),
                      r_hat=res.device_stats["r_hat"].numpy(),
                      n_eff=res.device_stats["n_eff"].numpy())
        return arrays, {"collectives": {k: v["count"] for k, v in res.collectives.items()},
                        "probe_evals": res.probe_evals}

    def adaptive_ref():
        arrays = {}
        for name, (model, dim, kw) in ADAPTIVE_REF.items():
            res = sample_sharded(model, {"x": torch.zeros(dim)}, **kw)
            arrays[f"{name}_x"] = res.samples["x"].numpy()
            arrays[f"{name}_inv_mass"] = res.tunables.inv_mass_diag.numpy()
            if res.device_stats is not None:
                arrays[f"{name}_r_hat"] = res.device_stats["r_hat"].numpy()
                arrays[f"{name}_n_eff"] = res.device_stats["n_eff"].numpy()
        return arrays, {}

    def chees(kw):
        res = sample_sharded(std_normal, {"x": torch.zeros(3)}, **kw)
        return {"x": res.samples["x"].numpy(), "counts": np.asarray(res.leapfrog_counts)}, {}

    def facade(sizes):
        arrays, meta = {}, {}
        for method, kw in sizes.items():
            mcmc = MCMC(facade_model)
            s = mcmc.run({"mu": 0.0, "sigma": 1.0}, method=method, num_chains=8,
                         chain_method="sharded", verbose=False, device="cpu", **kw)
            arrays[f"{method}_mu"] = s["mu"]
            meta[f"{method}_accept"] = mcmc.acceptance_rate
        return arrays, meta

    def errors():
        meta = {}
        calls = {
            "indivisible": lambda: sample_sharded(normal_model, {"x": torch.zeros(2)},
                                                  num_chains=7, num_samples=10, num_warmup=0,
                                                  device="cpu"),
            "chunk_diagnostics": lambda: sample_sharded(
                normal_model, {"x": torch.zeros(2)}, num_samples=10, num_warmup=0,
                draw_chunk=4, device_diagnostics=True, device="cpu"),
            "data_axis": lambda: sample_sharded(normal_model, {"x": torch.zeros(2)},
                                                data_axis="data", device="cpu"),
        }
        for name, call in calls.items():
            try:
                call()
                meta[name] = "no error"
            except (ValueError, NotImplementedError) as e:
                meta[name] = f"{type(e).__name__}: {e}"
        return {}, meta

    def chunk():
        model, dim, _ = FIXED["hmc"]
        chunked = sample_sharded(model, {"x": torch.zeros(dim)}, **CHUNK)
        whole = sample_sharded(model, {"x": torch.zeros(dim)}, **FIXED["hmc"][2])
        return dict(result_arrays(chunked), whole_x=whole.samples["x"].numpy(),
                    chunk_type=np.asarray(type(chunked.samples["x"]).__name__)), {}

    def payload():
        from mlx_mcmc_tpu_torch.parallel import chain_mesh

        model, dim, kw = FIXED["hmc"]
        res = sample_sharded(model, {"x": torch.zeros(dim)}, **kw)
        path = os.path.join(outdir, f"ckpt_rank{rank}")
        save_checkpoint(path, res)
        ckpt = load_checkpoint(path)
        try:
            resume(model, res, num_samples=4, device="cpu")
            refused = "no error"
        except ValueError as e:
            refused = str(e)
        rest = resume(model, path, num_samples=4, mesh=chain_mesh(), device="cpu")
        longer = sample_sharded(model, {"x": torch.zeros(dim)},
                                **dict(kw, num_samples=kw["num_samples"] + 4))
        arrays = {f"adapt_{i}": np.asarray(x) for i, x in enumerate(ckpt["adapt_leaves"])}
        arrays["x"] = ckpt["positions"]["x"]
        arrays["last_x"] = res.samples["x"][:, -1].numpy()
        arrays["rest_x"] = rest.samples["x"].numpy()
        arrays["longer_x"] = longer.samples["x"][:, kw["num_samples"]:].numpy()
        return arrays, {"mesh_axes": ckpt["mesh_axes"], "resume": refused}

    return {"fixed": fixed, "jitter": jitter, "glm": glm, "stats": stats, "adaptive": adaptive,
            "chees": lambda: chees(CHEES), "facade": lambda: facade(FACADE), "errors": errors,
            "chunk": chunk, "payload": payload, "adaptive_ref": adaptive_ref,
            "chees_ref": lambda: chees(CHEES_REF), "facade_ref": lambda: facade(FACADE_REF)}


SUITES = {
    "tier1": ("fixed", "jitter", "glm", "stats", "adaptive", "chees", "facade", "errors",
              "chunk", "payload"),
    "slow": ("adaptive_ref", "chees_ref", "facade_ref"),
}


def _init_suite(rank: int, world: int, port: int, env_port: int, outdir: str) -> None:
    """Two ranks initialize (explicit coordinator, then torchrun's
    variables), and a sum and a gather across them verify."""
    import torch.distributed as dist

    from mlx_mcmc_tpu_torch.parallel import initialize_distributed

    results = {}
    for how in ("explicit", "env"):
        if how == "explicit":
            initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
        else:
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                              MASTER_PORT=str(env_port))
            initialize_distributed(device="cpu")
        initialize_distributed(device="cpu")  # idempotent
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x)
        parts = [torch.empty(2) for _ in range(world)]
        dist.all_gather(parts, torch.tensor([float(rank), 10.0 * rank]))
        results[how] = {"backend": dist.get_backend(), "world": dist.get_world_size(),
                        "rank": dist.get_rank(), "sum": float(x),
                        "gathered": torch.cat(parts).tolist()}
        dist.destroy_process_group()
    with open(os.path.join(outdir, f"init.rank{rank}.json"), "w") as f:
        json.dump(results, f)


def main() -> None:
    rank, world, outdir, suite = int(sys.argv[1]), int(sys.argv[2]), sys.argv[4], sys.argv[5]
    port, env_port = (int(p) for p in sys.argv[3].split(","))
    torch.set_num_threads(1)
    if suite == "init":
        _init_suite(rank, world, port, env_port, outdir)
        print(f"DONE rank={rank}", flush=True)
        return
    import torch.distributed as dist

    from mlx_mcmc_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu")
    if suite in SUITES:
        scenarios, names = _scenarios(rank, world, outdir), SUITES[suite]
    else:
        import _torch_sharding_worker as sharding

        scenarios, names = sharding.scenarios(rank, world, outdir), sharding.SUITES[suite]
    try:
        for name in names:
            t0 = time.perf_counter()
            arrays, meta = scenarios[name]()
            np.savez(os.path.join(outdir, f"{name}.rank{rank}.npz"), meta=json.dumps(meta),
                     **arrays)
            print(f"{name} rank={rank} {time.perf_counter() - t0:.2f} s", flush=True)
        dist.barrier()  # no rank leaves while another still talks to it
    finally:
        from mlx_mcmc_tpu_torch import clear_runner_cache

        clear_runner_cache()  # the cached runners hold the groups
        dist.destroy_process_group()
    print(f"DONE rank={rank}", flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """SUITE running on ``world`` ranks, one process each, started at
    construction: the caller works on while they run, then :meth:`wait`s.
    A rank that fails or outlives ``timeout`` fails :meth:`wait`, and every
    rank is stopped."""

    def __init__(self, outdir, suite: str, world: int = 2, timeout: float = 600.0):
        self.outdir, self.timeout, self.outputs = str(outdir), timeout, None
        ports = f"{free_port()},{free_port()}"
        path = [REPO] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(path))
        script = os.path.join(REPO, "tests", os.path.basename(__file__))
        self.procs = [subprocess.Popen([sys.executable, script, str(r), str(world), ports,
                                        self.outdir, suite],
                                       cwd=REPO, env=env, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                      for r in range(world)]

    def wait(self) -> list:
        """Each rank's output, once every rank has ended well."""
        if self.outputs is None:
            outputs = []
            try:
                for p in self.procs:
                    outputs.append(p.communicate(timeout=self.timeout)[0])
            finally:
                self.stop()
            for r, (p, out) in enumerate(zip(self.procs, outputs)):
                if p.returncode != 0 or f"DONE rank={r}" not in out:
                    raise AssertionError(f"rank {r} failed (exit {p.returncode}):\n{out}")
            self.outputs = outputs
        return self.outputs

    def stop(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def load(self, name: str, rank: int = 0) -> tuple:
        """``(arrays, meta)`` that rank ``rank`` wrote for scenario ``name``
        (after :meth:`wait`)."""
        self.wait()
        with np.load(os.path.join(self.outdir, f"{name}.rank{rank}.npz")) as f:
            arrays = {k: f[k] for k in f.files if k != "meta"}
            meta = json.loads(str(f["meta"]))
        return arrays, meta


if __name__ == "__main__":
    main()
