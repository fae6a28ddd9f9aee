"""Scenarios of the port's observation sharding and sharded checkpoints on
four gloo ranks (suites ``data`` and ``resume`` of
``tests/_torch_parallel_worker.py``, which starts the ranks and writes
each scenario's results; ``tests/test_torch_data_sharding.py`` and
``tests/test_torch_sharded_resume.py`` read them).

Four ranks lay out as ``data_chain_mesh(2, 2)`` (a chain group and a data
group together), ``(1, 4)`` and ``(4, 1)``, and as ``chain_mesh()``. The
settings and models live here so that the tests can run the same ones in
one process. Imports nothing of JAX.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.distributed.tensor import Shard

WORLD = 4


def local_loglik(params, data):
    """The logistic likelihood of the observations in ``data`` (a shard's
    or all of them)."""
    s = data["X"] @ params["beta"]
    return torch.sum(data["y"] * s - torch.nn.functional.softplus(s))


def log_prior(params):
    from mlx_mcmc_tpu_torch import Normal

    return torch.sum(Normal(0.0, 1.0).log_prob(params["beta"]))


def full_model(params, data):
    return local_loglik(params, data) + log_prior(params)


def logistic(num_features: int = 8, num_obs: int = 64):
    """The reference's ``make_logistic_regression(seed=0)`` data (the
    port's generator draws its threefry streams): ``(spec, {"X", "y"})``."""
    from mlx_mcmc_tpu_torch.models import make_logistic_regression

    spec = make_logistic_regression(num_features=num_features, num_obs=num_obs, seed=0,
                                    device="cpu")
    return spec, {"X": spec.X, "y": spec.y}


# tests/test_data_sharding.py's short runs: fixed tunables, 5 + 5.
SHORT = dict(num_samples=5, num_warmup=5, num_chains=4, seed=0, step_size=0.05,
             adapt_step_size=False, adapt_mass_matrix=False, device="cpu")
SHORT_KERNELS = {"hmc": dict(num_leapfrog_steps=4), "chees": {}, "mala": {}, "metropolis": {},
                 "nuts": dict(max_tree_depth=4)}
# The fused protocol (test_data_sharding.py:129-200): 62 rows pad to 64 over
# four shards, so pad rows are present.
FUSED = dict(num_samples=3, num_warmup=2, num_chains=4, kernel="hmc", num_leapfrog_steps=2,
             seed=0, step_size=0.05, adapt_step_size=False, adapt_mass_matrix=False,
             device="cpu")
FUSED_SHAPE = dict(num_features=6, num_obs=62)
# The conjugate Gaussian (test_data_sharding.py:83-110): y ~ N(mu, 1) over
# 64 observations, mu ~ N(0, 10).
Y_CONJ = np.random.default_rng(0).normal(2.0, 1.0, size=64).astype(np.float32)
# Cut from the reference's 300 + 500 to 50 + 60 (the reference's size
# runs under -m slow): every evaluation is an autograd pass under vmap and a
# gloo all_reduce, 0.5 ms between two processes on the CPU.
RECOVERY = dict(num_samples=60, num_warmup=50, num_chains=4, kernel="hmc", seed=0,
                device="cpu")
RECOVERY_REF = dict(RECOVERY, num_samples=500, num_warmup=300)
# ChEES on the 2-D mesh (test_data_sharding.py:112-127), cut from 200 + 200 to 60 + 60
# (full under -m slow).
CHEES = dict(num_samples=60, num_warmup=60, num_chains=4, kernel="chees", seed=0, device="cpu")
CHEES_REF = dict(CHEES, num_samples=200, num_warmup=200)
# The adaptive run held against the JAX package's sample_sharded(data_axis=...)
# on data_chain_mesh(2, 4) of the 8 virtual devices, both on the fused
# protocol over f32 X (each package's data prepared for its data axis).
ADAPTIVE = dict(num_samples=300, num_warmup=100, num_chains=8, kernel="hmc",
                num_leapfrog_steps=5, seed=0)
# Draws in chunks on the data mesh (test_sharded_resume.py:116-141: 40 + 30
# in chunks of 12).
CHUNKED = dict(num_warmup=20, num_chains=4, kernel="hmc", seed=2, device="cpu")
CHUNKED_DRAWS, CHUNK = 20, 8


def conj_local(params, data):
    from mlx_mcmc_tpu_torch import Normal

    return torch.sum(Normal(params["mu"], 1.0).log_prob(data["y"]))


def conj_prior(params):
    from mlx_mcmc_tpu_torch import Normal

    return Normal(0.0, 10.0).log_prob(params["mu"])


def fixed_beta(dim: int, chains: int = 5) -> np.ndarray:
    """Seeded coefficients at which the value+grads are held."""
    return np.random.default_rng(7).normal(0.0, 1.0, (chains, dim)).astype(np.float32)


def fused_data(x_dtype, num_shards: int):
    from mlx_mcmc_tpu_torch.ops.glm import prepare_fused_logistic_data

    spec, _ = logistic(**FUSED_SHAPE)
    return spec, prepare_fused_logistic_data(spec.X.to(x_dtype), spec.y, num_shards=num_shards,
                                             device="cpu")


# --- sharded checkpoints (tests/test_sharded_resume.py) ---------------------
Y_RESUME = np.random.default_rng(0).normal(1.5, 1.0, 48).astype(np.float32)
Y_DATA_RESUME = np.random.default_rng(5).normal(2.0, 1.0, 64).astype(np.float32)


def resume_model(params, data):
    from mlx_mcmc_tpu_torch import Normal

    return (Normal(0.0, 10.0).log_prob(params["mu"])
            + torch.sum(Normal(0.0, 2.0).log_prob(params["w"]))
            + torch.sum(Normal(params["mu"] + params["w"].sum(), 1.0).log_prob(data["y"])))


def resume_init():
    return {"mu": torch.tensor(0.0), "w": torch.zeros(3)}


SPLIT = {"nuts": dict(max_tree_depth=5), "hmc": {}, "chees": {}}
# test_sharded_resume.py:146-171 at 60 + 20 + 20, cut to 30 + 10 + 10: the
# bits are the check, not the statistics.
SPLIT_WARMUP, SPLIT_HALF = 30, 10


def arrays(res, prefix: str = "") -> dict:
    """A result's draws and info fields as numpy arrays."""
    out = {f"{prefix}s_{k}": np.asarray(v if isinstance(v, np.ndarray) else v.float().numpy())
           for k, v in res.samples.items()}
    for field, x in zip(type(res.info)._fields, res.info):
        out[f"{prefix}i_{field}"] = np.asarray(x) if isinstance(x, np.ndarray) else x.numpy()
    return out


def _error(call) -> str:
    try:
        call()
    except (ValueError, TypeError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def scenarios(rank: int, world: int, outdir: str) -> dict:
    from mlx_mcmc_tpu_torch.io import load_checkpoint, resume, resume_warmup, run_warmup, \
        save_checkpoint
    from mlx_mcmc_tpu_torch.ops.glm import fused_data_specs, make_fused_logistic_vag
    from mlx_mcmc_tpu_torch.parallel import chain_mesh, data_chain_mesh, sample_sharded
    from mlx_mcmc_tpu_torch.parallel import sharded

    assert world == WORLD
    mesh22 = data_chain_mesh(2, 2)
    mesh14 = data_chain_mesh(1, 4)
    mesh41 = data_chain_mesh(4, 1)
    chains4 = chain_mesh()

    def on_data(model, init, mesh, data, **kw):
        return sample_sharded(model, init, mesh=mesh, data=data, data_axis="data", **kw)

    def short():
        spec, data = logistic()
        out, meta = {}, {}
        for kernel, extra in SHORT_KERNELS.items():
            res = on_data(local_loglik, spec.initial_params, mesh22, data,
                          log_prior_fn=log_prior, kernel=kernel, **extra, **SHORT)
            out.update(arrays(res, f"{kernel}_"))
            meta[kernel] = res.collectives["data"]["count"]
        # every layout of the four ranks, on HMC
        for name, mesh in (("1x4", mesh14), ("4x1", mesh41)):
            res = on_data(local_loglik, spec.initial_params, mesh, data, log_prior_fn=log_prior,
                          kernel="hmc", **SHORT_KERNELS["hmc"], **SHORT)
            out.update(arrays(res, f"hmc{name}_"))
        return out, {"data_collectives": meta}

    def fused():
        out, meta = {}, {}
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            spec, data = fused_data(dtype, 4)
            res = sample_sharded(None, spec.initial_params, mesh=mesh14, data=data,
                                 data_axis="data", data_specs=fused_data_specs(data, "data"),
                                 log_prior_fn=log_prior,
                                 value_and_grad_fn=make_fused_logistic_vag(include_prior=False),
                                 **FUSED)
            out.update(arrays(res, f"{name}_"))
            meta[f"{name}_pad_const"] = data["pad_const"]
            meta[f"{name}_rows"] = int(data["Xp"].shape[0])
        return out, meta

    def value_grad():
        """The data-axis value+grad itself at fixed coefficients on the
        (1, 4) mesh: the generic model, and the fused one on f32 and bf16
        X."""
        out = {}
        dgroup = mesh14.get_group("data")
        spec, data = logistic()
        Z = torch.from_numpy(fixed_beta(8))
        shard, vag = sharded._data_axis_model(local_loglik, None, log_prior, spec.initial_params,
                                              "hmc", data, None, "data", dgroup,
                                              torch.device("cpu"))
        out["generic_v"], out["generic_g"] = (t.numpy() for t in vag(Z, shard))
        out["generic_rows"] = np.asarray(shard["X"].shape[0])
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            spec, data = fused_data(dtype, 4)
            Z = torch.from_numpy(fixed_beta(6))
            shard, vag = sharded._data_axis_model(
                None, make_fused_logistic_vag(include_prior=False), log_prior,
                spec.initial_params, "hmc", data, fused_data_specs(data), "data", dgroup,
                torch.device("cpu"))
            out[f"{name}_v"], out[f"{name}_g"] = (t.numpy() for t in vag(Z, shard))
            out[f"{name}_count"] = np.asarray(vag.sum_over_shards.launches)
        return out, {}

    def recovery(kw):
        res = on_data(conj_local, {"mu": torch.tensor(0.0)}, mesh22,
                      {"y": torch.from_numpy(Y_CONJ)}, log_prior_fn=conj_prior, **kw)
        return {"mu": res.samples["mu"].numpy()}, {}

    def chees(kw):
        spec, data = logistic()
        res = on_data(local_loglik, spec.initial_params, mesh22, data, log_prior_fn=log_prior,
                      **kw)
        return {"beta": res.samples["beta"].numpy(),
                "counts": np.asarray(res.leapfrog_counts)}, {}

    def adaptive():
        from mlx_mcmc_tpu_torch.ops.glm import prepare_fused_logistic_data

        spec, _ = logistic()
        data = prepare_fused_logistic_data(spec.X, spec.y, num_shards=2, device="cpu")
        res = on_data(None, spec.initial_params, mesh22, data, log_prior_fn=log_prior,
                      value_and_grad_fn=make_fused_logistic_vag(include_prior=False),
                      device="cpu", **ADAPTIVE)
        return {"beta": res.samples["beta"].numpy(),
                "inv_mass": res.tunables.inv_mass_diag.numpy()}, {
            "accept": res.acceptance_rate, "collectives": res.collectives}

    def chunked():
        d = {"y": torch.from_numpy(Y_DATA_RESUME)}
        kw = dict(mesh=mesh22, data=d, data_axis="data", log_prior_fn=conj_prior, **CHUNKED)
        full = sample_sharded(conj_local, {"mu": torch.tensor(0.0)}, num_samples=CHUNKED_DRAWS,
                              **kw)
        parts = sample_sharded(conj_local, {"mu": torch.tensor(0.0)}, num_samples=CHUNKED_DRAWS,
                               draw_chunk=CHUNK, **kw)
        return {"full": full.samples["mu"].numpy(), "chunked": parts.samples["mu"]}, {}

    def errors():
        spec, data = logistic()
        init = spec.initial_params
        return {}, {
            "dynamic_nuts": _error(lambda: on_data(
                local_loglik, init, mesh22, data, log_prior_fn=log_prior, kernel="nuts",
                static_schedule=False, num_samples=2, num_warmup=2, num_chains=4,
                device="cpu")),
            "requires_data": _error(lambda: sample_sharded(
                lambda p: log_prior({"beta": p["x"]}), {"x": torch.tensor(0.0)}, mesh=mesh22,
                data_axis="data", kernel="hmc", num_chains=4, device="cpu")),
            "unknown_axis": _error(lambda: sample_sharded(
                local_loglik, init, mesh=mesh22, data={"y": torch.zeros(8)}, data_axis="obs",
                kernel="hmc", num_chains=4, device="cpu")),
            "prior_without_axis": _error(lambda: sample_sharded(
                local_loglik, init, mesh=mesh22, data=data, log_prior_fn=log_prior,
                kernel="hmc", num_chains=4, device="cpu")),
        }

    # --- sharded checkpoints ---------------------------------------------
    r_data = {"y": torch.from_numpy(Y_RESUME)}
    d_data = {"y": torch.from_numpy(Y_DATA_RESUME)}

    def path(name):
        return os.path.join(outdir, f"{name}.rank{rank}.ckpt.npz")

    def split():
        out = {}
        for kernel, extra in SPLIT.items():
            kw = dict(num_chains=8, kernel=kernel, seed=13, num_warmup=SPLIT_WARMUP, data=r_data,
                      device="cpu", **extra)
            full = sample_sharded(resume_model, resume_init(), num_samples=2 * SPLIT_HALF, **kw)
            half = sample_sharded(resume_model, resume_init(), num_samples=SPLIT_HALF, **kw)
            save_checkpoint(path(f"split_{kernel}"), half)
            rest = resume(resume_model, path(f"split_{kernel}"), num_samples=SPLIT_HALF,
                          data=r_data, mesh=chains4, device="cpu")
            out[f"{kernel}_full"] = full.samples["w"].numpy()
            out[f"{kernel}_glued"] = np.concatenate([half.samples["w"].numpy(),
                                                     rest.samples["w"].numpy()], axis=1)
            out[f"{kernel}_full_accept"] = full.info.accept_prob.numpy()[:, SPLIT_HALF:]
            out[f"{kernel}_rest_accept"] = rest.info.accept_prob.numpy()
            out[f"{kernel}_axis_size"] = np.asarray(half.resume_payload["mesh_axes"]["axis_size"])
        return out, {}

    def live():
        kw = dict(num_chains=8, kernel="hmc", seed=3, num_warmup=50, data=r_data, device="cpu")
        full = sample_sharded(resume_model, resume_init(), num_samples=30, **kw)
        a = sample_sharded(resume_model, resume_init(), num_samples=10, **kw)
        b = resume(resume_model, a, num_samples=10, data=r_data, mesh=chains4, device="cpu")
        c = resume(resume_model, b, num_samples=10, data=r_data, mesh=chains4, device="cpu")
        return {"full": full.samples["mu"].numpy(),
                "glued": np.concatenate([r.samples["mu"].numpy() for r in (a, b, c)], axis=1)}, {}

    def mismatch():
        from mlx_mcmc_tpu_torch import sample

        kw = dict(num_samples=10, num_chains=8, kernel="hmc", seed=0, num_warmup=20, data=r_data,
                  device="cpu")
        half = sample_sharded(resume_model, resume_init(), **kw)
        plain = sample(resume_model, resume_init(), **kw)
        cont = dict(num_samples=10, data=r_data, device="cpu")
        return {}, {
            "other_layout": _error(lambda: resume(resume_model, half, mesh=mesh22, **cont)),
            "no_mesh": _error(lambda: resume(resume_model, half, **cont)),
            "unsharded_to_sharded": _error(lambda: resume(resume_model, plain, mesh=chains4,
                                                          **cont)),
        }

    def data_resume():
        kw = dict(num_warmup=30, num_chains=4, kernel="hmc", seed=7, mesh=mesh22, data=d_data,
                  data_axis="data", log_prior_fn=conj_prior, device="cpu")
        full = sample_sharded(conj_local, {"mu": torch.tensor(0.0)}, num_samples=16, **kw)
        half = sample_sharded(conj_local, {"mu": torch.tensor(0.0)}, num_samples=8, **kw)
        cont = dict(num_samples=8, data=d_data, mesh=mesh22, data_axis="data", device="cpu")
        meta = {
            "no_prior": _error(lambda: resume(conj_local, half, **cont)),
            "extra_specs": _error(lambda: resume(conj_local, half, log_prior_fn=conj_prior,
                                                 data_specs={"y": Shard(0)}, **cont)),
        }
        rest = resume(conj_local, half, log_prior_fn=conj_prior, **cont)
        return {"full": full.samples["mu"].numpy(),
                "glued": np.concatenate([half.samples["mu"].numpy(), rest.samples["mu"].numpy()],
                                        axis=1)}, meta

    def after_chunk():
        kw = dict(num_warmup=30, num_chains=8, kernel="hmc", seed=4, data=r_data, device="cpu")
        full = sample_sharded(resume_model, resume_init(), num_samples=30, **kw)
        half = sample_sharded(resume_model, resume_init(), num_samples=15, draw_chunk=6, **kw)
        rest = resume(resume_model, half, num_samples=15, data=r_data, mesh=chains4,
                      device="cpu")
        return {"full": full.samples["mu"].numpy(),
                "glued": np.concatenate([half.samples["mu"], rest.samples["mu"].numpy()],
                                        axis=1)}, {}

    def warmup():
        out = {}
        # the chain mesh, through the disk
        kw = dict(num_warmup=30, num_chains=8, kernel="hmc", seed=9, data=r_data, device="cpu")
        full = sample_sharded(resume_model, resume_init(), num_samples=10, **kw)
        ckpt = run_warmup(resume_model, resume_init(), stop=15, mesh=chains4, **kw)
        save_checkpoint(path("warmup"), ckpt)
        loaded = load_checkpoint(path("warmup"))
        rest = resume_warmup(resume_model, loaded, num_samples=10, data=r_data, mesh=chains4,
                             device="cpu")
        out["chain_full"], out["chain_rest"] = full.samples["w"].numpy(), rest.samples["w"].numpy()
        out["chain_tiled"] = np.asarray(loaded["adapt_leaves"][0].shape)
        # the data mesh, in three segments, HMC
        kw = dict(num_warmup=24, num_chains=4, kernel="hmc", seed=5, data=d_data,
                  device="cpu")
        shard = dict(mesh=mesh22, data_axis="data", log_prior_fn=conj_prior)
        full = sample_sharded(conj_local, {"mu": torch.tensor(0.0)}, num_samples=8, **kw,
                              **shard)
        a = run_warmup(conj_local, {"mu": torch.tensor(0.0)}, stop=8, **kw, **shard)
        b = resume_warmup(conj_local, a, stop=16, data=d_data, device="cpu", **shard)
        c = resume_warmup(conj_local, b, num_samples=8, data=d_data, device="cpu", **shard)
        out["data_full"], out["data_rest"] = full.samples["mu"].numpy(), c.samples["mu"].numpy()
        meta = {"mesh_axes": b["mesh_axes"],
                "warmup_other_layout": _error(lambda: resume_warmup(
                    conj_local, a, data=d_data, device="cpu", mesh=mesh14, data_axis="data",
                    log_prior_fn=conj_prior)),
                "warmup_no_prior": _error(lambda: resume_warmup(
                    conj_local, a, data=d_data, device="cpu", mesh=mesh22,
                    data_axis="data"))}
        return out, meta

    def guards():
        kw = dict(num_chains=8, kernel="hmc", seed=1, num_warmup=20, data=r_data, device="cpu")
        half = sample_sharded(resume_model, resume_init(), num_samples=5, **kw)
        ckpt = run_warmup(resume_model, resume_init(), stop=10, mesh=chains4, **kw)
        legacy = resume_warmup(resume_model, ckpt, num_samples=5, data=r_data, mesh=chains4,
                               device="cpu")
        save_checkpoint(path("legacy"), legacy)  # no payload: position-only
        cont = dict(num_samples=5, data=r_data, device="cpu")
        return {}, {
            "legacy_mesh": _error(lambda: resume(resume_model, path("legacy"), mesh=chains4,
                                                 **cont)),
            "unknown_kwarg": _error(lambda: resume(resume_model, half, mesh=chains4, bogus=1,
                                                   **cont)),
            "resume_mesh_prefix": _error(lambda: resume(resume_model, half, mesh=mesh22,
                                                        **cont)),
            "extra_prior": _error(lambda: resume(resume_model, half, mesh=chains4,
                                                 log_prior_fn=conj_prior, **cont)),
            "warmup_unknown_kwarg": _error(lambda: run_warmup(
                resume_model, resume_init(), stop=10, mesh=chains4, bogus=1, **kw)),
            "legacy_loaded": str(sorted(load_checkpoint(path("legacy")))),
        }

    return {"short": short, "fused": fused, "value_grad": value_grad,
            "recovery": lambda: recovery(RECOVERY), "chees_2d": lambda: chees(CHEES),
            "recovery_ref": lambda: recovery(RECOVERY_REF),
            "chees_ref": lambda: chees(CHEES_REF), "adaptive": adaptive, "chunked": chunked,
            "data_errors": errors,
            "split": split, "live": live, "mismatch": mismatch, "data_resume": data_resume,
            "after_chunk": after_chunk, "warmup": warmup, "guards": guards}


SUITES = {
    "data": ("value_grad", "short", "fused", "data_errors", "chunked", "recovery", "chees_2d",
             "adaptive"),
    "data_slow": ("recovery_ref", "chees_ref"),
    "resume": ("split", "live", "mismatch", "data_resume", "after_chunk", "warmup", "guards"),
}
