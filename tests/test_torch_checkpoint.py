"""Checkpoint and resume (``io/checkpoint.py``), after the reference's
``tests/test_checkpoint.py`` (its single-device npz cases; Orbax is
JAX-only and the sharded paths wait for ROADMAP A.10), with MALA added to
its kernels.

The engine keys every random input and schedule flag by the global step,
so ``sample(N)`` equals ``sample(N/2)`` -> save -> ``resume(N/2)`` and an
uninterrupted run equals ``run_warmup`` -> save -> ``resume_warmup``, draw
for draw, bits and not approximately. Between the packages:
- each package's ``load_checkpoint`` reads the other's legacy, sampling and
  warmup files to the same meta and arrays;
- a reference warmup checkpoint rebuilds, in the port, the reference's
  adaptation state (step size, inverse mass);
- a reference sampling checkpoint resumes in the port with one warning
  (the port's streams are not the reference's) and its posterior;
- the data fingerprints are the reference's strings;
- the guards the reference has one way (the data fingerprint and callable
  kwargs of a warmup checkpoint) hold both ways.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_mcmc_tpu as jmm
from mlx_mcmc_tpu.io import checkpoint as jckpt
from mlx_mcmc_tpu_torch import Normal, clear_runner_cache, sample
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size
from mlx_mcmc_tpu_torch.inference.api import _RUNNER_CACHE
from mlx_mcmc_tpu_torch.inference.engine import data_fingerprint
from mlx_mcmc_tpu_torch.io import (
    load_checkpoint,
    resume,
    resume_warmup,
    run_warmup,
    save_checkpoint,
)
from mlx_mcmc_tpu_torch.io import checkpoint as ckpt_mod
from mlx_mcmc_tpu_torch.ops.glm import prepare_fused_logistic_data
from mlx_mcmc_tpu_torch.utils import AdaptationConfig, SamplerConfig

CPU = dict(device="cpu")
# NUTS runs below cap their depth at 5-6: on the CPU the deep trees of early
# warmup would dominate the file's time, and depth is not what they test.


def _model(params):
    return torch.sum(Normal(2.0, 1.0).log_prob(params["x"]))


def _j_model(params):
    return jnp.sum(jmm.Normal(2.0, 1.0).log_prob(params["x"]))


def _arrays_meta(result):
    meta, arrays = ckpt_mod._sampling_payload(result.resume_payload)
    return arrays, meta


def _x(r):
    x = r.samples["x"]
    return x if isinstance(x, np.ndarray) else x.numpy()


class TestCheckpoint:
    def test_save_load_roundtrip(self, tmp_path):
        res = sample(_model, {"x": torch.zeros(3)}, num_samples=200, num_warmup=200, num_chains=4,
                     kernel="nuts", seed=0, max_tree_depth=6, **CPU)
        path = str(tmp_path / "ckpt.npz")
        save_checkpoint(path, res)
        ckpt = load_checkpoint(path)
        assert ckpt["kernel"] == "nuts" and ckpt["num_chains"] == 4
        assert ckpt["positions"]["x"].shape == (4, 3)
        np.testing.assert_allclose(ckpt["inv_mass_diag"], res.tunables.inv_mass_diag.numpy())

    def test_resume_continues_sampling(self, tmp_path):
        res = sample(_model, {"x": torch.zeros(2)}, num_samples=300, num_warmup=300, num_chains=2,
                     kernel="nuts", seed=0, max_tree_depth=5, **CPU)
        path = str(tmp_path / "ckpt.npz")
        save_checkpoint(path, res)
        res2 = resume(_model, path, num_samples=1000, **CPU)
        xs = _x(res2).reshape(-1, 2)
        # the adapted tunables carry over, and the chains stay in the target
        assert float(res2.tunables.step_size) == float(res.tunables.step_size)
        assert np.all(np.abs(xs.mean(axis=0) - 2.0) < 0.15)
        assert res2.probe_evals == 0

    def test_resume_from_dict(self):
        res = sample(_model, {"x": torch.zeros(2)}, num_samples=100, num_warmup=100, num_chains=2,
                     kernel="hmc", seed=0, **CPU)
        res2 = resume(_model, ckpt_mod._result_state(res), num_samples=100, **CPU)
        assert res2.samples["x"].shape == (2, 100, 2)


class TestExactSamplingResume:
    """A sampling checkpoint continues bit for bit: ``sample(N)`` equals
    ``sample(N/2)`` -> save -> ``resume(N/2)``."""

    @pytest.mark.parametrize("kernel", ["nuts", "hmc", "chees", "metropolis", "mala"])
    def test_split_equals_uninterrupted(self, kernel, tmp_path):
        kw = dict(num_chains=4, kernel=kernel, seed=13, num_warmup=60, **CPU)
        if kernel == "nuts":
            kw["max_tree_depth"] = 5
        full = sample(_model, {"x": torch.zeros(3)}, num_samples=40, **kw)
        half = sample(_model, {"x": torch.zeros(3)}, num_samples=20, **kw)
        path = str(tmp_path / f"sampling_{kernel}.npz")
        save_checkpoint(path, half)
        rest = resume(_model, path, num_samples=20, **CPU)
        np.testing.assert_array_equal(_x(full), np.concatenate([_x(half), _x(rest)], axis=1))
        # diagnostics continue identically too, and no probe runs again
        for name, a, b in zip(type(full.info)._fields, full.info, rest.info):
            np.testing.assert_array_equal(a.numpy()[:, 20:], b.numpy(), err_msg=name)
        assert rest.probe_evals == 0
        assert full.leapfrog_counts[80:] == rest.leapfrog_counts

    def test_chained_resumes(self):
        kw = dict(num_chains=2, kernel="hmc", seed=3, num_warmup=50, **CPU)
        full = sample(_model, {"x": torch.zeros(2)}, num_samples=30, **kw)
        a = sample(_model, {"x": torch.zeros(2)}, num_samples=10, **kw)
        b = resume(_model, a, num_samples=10, **CPU)  # live result, no disk
        c = resume(_model, b, num_samples=10, **CPU)
        np.testing.assert_array_equal(_x(full), np.concatenate([_x(r) for r in (a, b, c)], 1))

    def test_resume_with_thin(self):
        kw = dict(num_chains=2, kernel="hmc", seed=5, num_warmup=40, thin=3, **CPU)
        full = sample(_model, {"x": torch.zeros(2)}, num_samples=20, **kw)
        half = sample(_model, {"x": torch.zeros(2)}, num_samples=10, **kw)
        rest = resume(_model, half, num_samples=10, **CPU)
        np.testing.assert_array_equal(_x(full), np.concatenate([_x(half), _x(rest)], axis=1))

    def test_resume_with_draw_chunk_and_bf16_store(self, tmp_path):
        # the payload takes the last chunk's float32 positions, never the
        # bf16 draws
        kw = dict(num_chains=2, kernel="hmc", seed=9, num_warmup=30, store_dtype="bfloat16",
                  **CPU)
        full = sample(_model, {"x": torch.zeros(2)}, num_samples=24, **kw)
        half = sample(_model, {"x": torch.zeros(2)}, num_samples=12, draw_chunk=5, **kw)
        save_checkpoint(str(tmp_path / "chunked"), half)
        rest = resume(_model, str(tmp_path / "chunked"), num_samples=12, **CPU)
        assert rest.samples["x"].dtype == torch.bfloat16
        np.testing.assert_array_equal(full.samples["x"].float().numpy(),
                                      np.concatenate([_x(half), rest.samples["x"].float().numpy()],
                                                     axis=1))

    def test_resume_with_data_and_transforms(self, tmp_path):
        rng = np.random.default_rng(2)
        data = {"y": torch.from_numpy(rng.normal(1.0, 0.5, 32).astype(np.float32))}

        def lp(params, data):
            return (Normal(0.0, 5.0).log_prob(params["mu"])
                    + Normal(0.0, 1.0).log_prob(torch.log(params["sigma"]))
                    + torch.sum(Normal(params["mu"], params["sigma"]).log_prob(data["y"])))

        kw = dict(num_chains=2, kernel="nuts", seed=8, num_warmup=50, max_tree_depth=5, data=data,
                  transforms={"sigma": "log"}, **CPU)
        init = {"mu": 0.0, "sigma": 1.0}
        full = sample(lp, init, num_samples=24, **kw)
        half = sample(lp, init, num_samples=12, **kw)
        path = str(tmp_path / "tr.npz")
        save_checkpoint(path, half)
        rest = resume(lp, path, num_samples=12, data=data, transforms={"sigma": "log"}, **CPU)
        np.testing.assert_array_equal(
            full.samples["sigma"].numpy(),
            np.concatenate([half.samples["sigma"].numpy(), rest.samples["sigma"].numpy()], 1))
        # a transforms or data mismatch is rejected, not silently wrong
        with pytest.raises(ValueError, match="transforms"):
            resume(lp, path, num_samples=4, data=data, **CPU)
        with pytest.raises(ValueError, match="fingerprint"):
            resume(lp, path, num_samples=4, data={"y": torch.zeros(16)},
                   transforms={"sigma": "log"}, **CPU)

    def test_contradicting_kwargs_rejected(self):
        half = sample(_model, {"x": torch.zeros(2)}, num_samples=10, num_chains=2, kernel="nuts",
                      seed=0, num_warmup=30, max_tree_depth=5, **CPU)
        with pytest.raises(ValueError, match="max_tree_depth"):
            resume(_model, half, num_samples=10, max_tree_depth=7, **CPU)
        with pytest.raises(ValueError, match="step_size"):
            resume(_model, half, num_samples=10, step_size=0.1, **CPU)

    def test_explicit_seed_on_exact_checkpoint_warns(self):
        half = sample(_model, {"x": torch.zeros(2)}, num_samples=10, num_chains=2, kernel="hmc",
                      seed=0, num_warmup=20, **CPU)
        with pytest.warns(UserWarning, match="`seed` is ignored"):
            res = resume(_model, half, num_samples=10, seed=99, **CPU)
        assert res.samples["x"].shape == (2, 10, 2)

    def test_warmup_checkpoint_routed_to_resume_warmup(self):
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=40, stop=20, num_chains=2,
                          seed=0, **CPU)
        with pytest.raises(ValueError, match="resume_warmup"):
            resume(_model, ckpt, num_samples=10, **CPU)

    def test_result_without_payload_resumes_statistically(self, tmp_path):
        # The port's seeds are ints, so every sample() result has a payload;
        # resume_warmup's result has none (as in the reference), is saved
        # position-only and resumes on a fresh stream.
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=20, stop=10, num_chains=2,
                          kernel="hmc", seed=0, **CPU)
        res = resume_warmup(_model, ckpt, num_samples=10, **CPU)
        assert res.resume_payload is None
        res2 = resume(_model, res, num_samples=10, **CPU)
        assert res2.samples["x"].shape == (2, 10, 2)
        save_checkpoint(str(tmp_path / "legacy.npz"), res)
        legacy = load_checkpoint(str(tmp_path / "legacy.npz"))
        assert "phase" not in legacy and legacy["draws_completed"] == 10
        np.testing.assert_array_equal(legacy["positions"]["x"], _x(res)[:, -1])

    def test_missing_callable_kwarg_rejected(self):
        def my_vag(Z):
            return -0.5 * ((Z - 2.0) ** 2).sum(-1), -(Z - 2.0)

        half = sample(_model, {"x": torch.zeros(2)}, num_samples=10, num_chains=2, kernel="hmc",
                      seed=0, num_warmup=20, value_and_grad_fn=my_vag, **CPU)
        with pytest.raises(ValueError, match="value_and_grad_fn"):
            resume(_model, half, num_samples=10, **CPU)
        res = resume(_model, half, num_samples=10, value_and_grad_fn=my_vag, **CPU)
        assert res.samples["x"].shape == (2, 10, 2)

    def test_repeated_resume_hits_runner_cache(self):
        # A continuation replays the runner (and its graphs, on the card) of
        # the run it continues: neither resume adds a runner.
        clear_runner_cache()
        half = sample(_model, {"x": torch.zeros(2)}, num_samples=10, num_chains=2, kernel="hmc",
                      seed=6, num_warmup=20, **CPU)
        assert len(_RUNNER_CACHE) == 1
        a = resume(_model, half, num_samples=10, **CPU)
        assert len(_RUNNER_CACHE) == 1
        b = resume(_model, a, num_samples=10, **CPU)
        assert len(_RUNNER_CACHE) == 1
        assert b.samples["x"].shape == (2, 10, 2)
        # from a checkpoint dict into an empty cache: the first resume
        # builds the runner, the second (from the live result) reuses it
        clear_runner_cache()
        a2 = resume(_model, ckpt_mod._load_sampling(*_arrays_meta(half)), num_samples=10, **CPU)
        assert len(_RUNNER_CACHE) == 1
        resume(_model, half, num_samples=10, **CPU)
        assert len(_RUNNER_CACHE) == 1
        np.testing.assert_array_equal(_x(a2), _x(a))


class TestMidWarmupResume:
    """Resume mid-warmup: interrupted at step k equals uninterrupted, bit for
    bit, the rest of warmup and the draws."""

    @pytest.mark.parametrize("kernel", ["nuts", "hmc", "chees", "mala"])
    def test_interrupted_equals_uninterrupted(self, kernel, tmp_path):
        kwargs = dict(num_chains=4, kernel=kernel, seed=7, **CPU)
        if kernel == "nuts":
            kwargs["max_tree_depth"] = 6
        full = sample(_model, {"x": torch.zeros(3)}, num_warmup=80, num_samples=40, **kwargs)
        ckpt = run_warmup(_model, {"x": torch.zeros(3)}, num_warmup=80, stop=33, **kwargs)
        path = str(tmp_path / f"warmup_{kernel}.npz")
        save_checkpoint(path, ckpt)
        res = resume_warmup(_model, load_checkpoint(path), num_samples=40, **CPU)
        np.testing.assert_array_equal(_x(res), _x(full))
        for name, a, b in zip(type(full.info)._fields, full.info, res.info):
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)
        assert float(res.tunables.step_size) == float(full.tunables.step_size)
        # one probe in all: the segment's; the continuation's host syncs are
        # the rest of the run's
        assert ckpt["probe_evals"] == full.probe_evals and res.probe_evals == 0
        assert ckpt["host_syncs"] + res.host_syncs == full.host_syncs
        assert full.leapfrog_counts[33:] == res.leapfrog_counts

    def test_chained_segments(self):
        kwargs = dict(num_chains=2, kernel="nuts", seed=3, max_tree_depth=6, **CPU)
        full = sample(_model, {"x": torch.zeros(2)}, num_warmup=60, num_samples=20, **kwargs)
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=60, stop=10, **kwargs)
        ckpt = resume_warmup(_model, ckpt, stop=45, **CPU)  # a second segment
        assert ckpt["warmup_step"] == 45
        res = resume_warmup(_model, ckpt, num_samples=20, **CPU)
        np.testing.assert_array_equal(_x(res), _x(full))

    def test_segments_share_the_runs_runner(self):
        # run_warmup, resume_warmup and sample() with the same settings run
        # on one cached runner (on the card: one set of graphs)
        clear_runner_cache()
        kwargs = dict(num_chains=2, kernel="nuts", seed=3, max_tree_depth=6, **CPU)
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=60, stop=10, **kwargs)
        ckpt = resume_warmup(_model, ckpt, stop=45, **CPU)
        res = resume_warmup(_model, ckpt, num_samples=20, **CPU)
        assert len(_RUNNER_CACHE) == 1
        full = sample(_model, {"x": torch.zeros(2)}, num_warmup=60, num_samples=20, **kwargs)
        assert len(_RUNNER_CACHE) == 1
        np.testing.assert_array_equal(_x(res), _x(full))

    def test_warmup_checkpoint_carries_adaptation(self):
        # Stan's schedule for 200 warmup steps: slow windows end at steps 99
        # and 149, so a checkpoint at 120 has a refreshed mass matrix.
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=200, stop=120, num_chains=2,
                          kernel="nuts", seed=0, max_tree_depth=6, **CPU)
        assert ckpt["phase"] == "warmup"
        # 5 dual-averaging leaves + 3 Welford leaves + inv_mass_diag
        assert len(ckpt["adapt_leaves"]) == 9
        assert not np.allclose(ckpt["adapt_leaves"][-1], 1.0)

    def test_bad_phase_rejected(self):
        res = sample(_model, {"x": torch.zeros(2)}, num_samples=20, num_warmup=20, num_chains=2,
                     seed=0, **CPU)
        with pytest.raises(ValueError, match="mid-warmup"):
            resume_warmup(_model, ckpt_mod._result_state(res), num_samples=10, **CPU)

    def test_invalid_stop_rejected(self):
        with pytest.raises(ValueError, match="stop"):
            run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=50, stop=60, num_chains=2, **CPU)

    def test_non_int_seed_rejected_early(self):
        with pytest.raises(TypeError, match="int seed"):
            run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=50, stop=10, num_chains=2,
                       seed=torch.Generator(), **CPU)

    def test_resume_rejects_contradicting_kwargs(self):
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=60, stop=20, num_chains=2,
                          kernel="nuts", seed=0, max_tree_depth=6, **CPU)
        resume_warmup(_model, ckpt, stop=30, max_tree_depth=6, **CPU)  # the same value: fine
        with pytest.raises(ValueError, match="max_tree_depth"):
            resume_warmup(_model, ckpt, stop=30, max_tree_depth=8, **CPU)

    def test_resume_reapplies_stored_kwargs(self):
        kwargs = dict(num_chains=2, kernel="nuts", seed=5, max_tree_depth=4, **CPU)
        full = sample(_model, {"x": torch.zeros(2)}, num_warmup=60, num_samples=20, **kwargs)
        ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=60, stop=25, **kwargs)
        res = resume_warmup(_model, ckpt, num_samples=20, **CPU)  # no kwargs
        np.testing.assert_array_equal(_x(res), _x(full))

    def test_resume_rejects_mismatched_data(self):
        def model_with_data(params, data=None):
            return torch.sum(Normal(data["mu"], 1.0).log_prob(params["x"]))

        data = {"mu": torch.ones(3)}
        ckpt = run_warmup(model_with_data, {"x": torch.zeros(3)}, num_warmup=60, stop=20,
                          num_chains=2, data=data, **CPU)
        resume_warmup(model_with_data, ckpt, stop=30, data=data, **CPU)  # ok
        with pytest.raises(ValueError, match="data"):
            resume_warmup(model_with_data, ckpt, stop=30, data={"mu": torch.ones(4)}, **CPU)


class TestConfig:
    def test_sampler_config_roundtrip(self):
        cfg = SamplerConfig(kernel="hmc", num_samples=150, num_warmup=100, num_chains=2,
                            num_leapfrog_steps=5, adaptation=AdaptationConfig(target_accept=0.9))
        res = sample(_model, {"x": torch.zeros(2)}, config=cfg, **CPU)
        assert res.samples["x"].shape == (2, 150, 2) and res.kernel == "hmc"

    def test_config_drops_irrelevant_kernel_fields(self):
        kw = SamplerConfig(kernel="nuts").to_kwargs()
        assert "num_leapfrog_steps" not in kw and "max_leapfrog_steps" not in kw
        assert kw["max_tree_depth"] == 10
        kw = SamplerConfig(kernel="hmc").to_kwargs()
        assert "max_tree_depth" not in kw and "max_leapfrog_steps" not in kw

    def test_config_chees_trajectory_cap(self):
        kw = SamplerConfig(kernel="chees", max_leapfrog_steps=64).to_kwargs()
        assert kw["max_leapfrog_steps"] == 64 and "max_tree_depth" not in kw
        cfg = SamplerConfig(kernel="chees", num_samples=60, num_warmup=80, num_chains=2,
                            max_leapfrog_steps=32)
        res = sample(_model, {"x": torch.zeros(2)}, config=cfg, **CPU)
        assert res.samples["x"].shape == (2, 60, 2)

    @pytest.mark.parametrize("kernel", ["metropolis", "mala"])
    def test_config_gradient_free_kernels(self, kernel):
        cfg = SamplerConfig(kernel=kernel, num_samples=50, num_warmup=50, num_chains=2)
        kw = cfg.to_kwargs()
        for k in ("num_leapfrog_steps", "max_tree_depth", "max_leapfrog_steps"):
            assert k not in kw
        res = sample(_model, {"x": torch.zeros(2)}, config=cfg, **CPU)
        assert res.samples["x"].shape == (2, 50, 2)


# --- between the packages ----------------------------------------------------


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each package's legacy, sampling and warmup files of the same model."""
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    kw = dict(num_chains=4, kernel="hmc", num_leapfrog_steps=3)
    j_exact = jmm.sample(_j_model, {"x": jnp.zeros(3)}, num_warmup=200, num_samples=10, seed=4,
                         **kw)
    j_legacy = jmm.sample(_j_model, {"x": jnp.zeros(3)}, num_warmup=20, num_samples=10,
                          seed=jax.random.PRNGKey(4), **kw)
    j_warm = jckpt.run_warmup(_j_model, {"x": jnp.zeros(3)}, num_warmup=200, stop=120, seed=4,
                              **kw)
    t_exact = sample(_model, {"x": torch.zeros(3)}, num_warmup=20, num_samples=10, seed=4, **kw,
                     **CPU)
    t_warm = run_warmup(_model, {"x": torch.zeros(3)}, num_warmup=40, stop=25, seed=4, **kw, **CPU)
    t_legacy = resume_warmup(_model, t_warm, num_samples=5, **CPU)
    for pkg, save, items in (("jax", jckpt.save_checkpoint,
                              {"sampling": j_exact, "legacy": j_legacy, "warmup": j_warm}),
                             ("torch", save_checkpoint,
                              {"sampling": t_exact, "legacy": t_legacy, "warmup": t_warm})):
        for kind, obj in items.items():
            path = str(root / f"{pkg}_{kind}.npz")
            save(path, obj, backend="npz")
            out[pkg, kind] = path
    out["j_warm"] = j_warm
    return out


def _same(a, b) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


@pytest.mark.parametrize("kind", ["legacy", "sampling", "warmup"])
def test_each_package_reads_the_others_files(files, kind):
    for pkg in ("jax", "torch"):
        mine = load_checkpoint(files[pkg, kind])
        theirs = jckpt.load_checkpoint(files[pkg, kind])
        # the port's warmup loader adds callable_kwargs and rng (None: the
        # reference's file names no stream)
        extra = {"callable_kwargs", "rng"} if kind == "warmup" else set()
        assert set(mine) - set(theirs) == extra and set(theirs) <= set(mine)
        _same({k: mine[k] for k in theirs}, theirs)
        if kind == "sampling":
            assert mine.get("rng") == (ckpt_mod.RNG if pkg == "torch" else None)
        if kind != "legacy":
            for leaf in mine["adapt_leaves"]:
                assert leaf.dtype == np.float32


def test_reference_warmup_checkpoint_rebuilds_its_adaptation(files):
    j_state = jckpt._resume_state_from_ckpt(jckpt.load_checkpoint(files["jax", "warmup"]))[0]
    adapt, traj = ckpt_mod._resume_state_from_ckpt(load_checkpoint(files["jax", "warmup"]), "cpu")
    assert traj == ()
    for mine, ref in zip(ckpt_mod._tree_leaves(adapt), jax.tree_util.tree_leaves(j_state)):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    np.testing.assert_allclose(float(torch.exp(adapt.da.log_step)),
                               float(jnp.exp(j_state.da.log_step)), rtol=1e-6)
    assert not np.allclose(adapt.inv_mass_diag.numpy(), 1.0)  # adapted past a window


def test_reference_checkpoints_continue_statistically_with_one_warning(files):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = resume(_model, files["jax", "sampling"], num_samples=400, num_leapfrog_steps=3,
                     **CPU)
    mine = [str(w.message) for w in caught if "checkpoint" in str(w.message)]
    assert len(mine) == 1 and "statistical" in mine[0]
    x = _x(res)  # (4, 400, 3), target N(2, 1)
    ess = effective_sample_size(x)
    mcse = x.reshape(-1, 3).std(axis=0) / np.sqrt(ess)
    assert np.all(np.abs(x.reshape(-1, 3).mean(axis=0) - 2.0) < 4 * mcse)
    assert res.probe_evals == 0
    with pytest.warns(UserWarning, match="statistical") as caught:
        res = resume_warmup(_model, files["j_warm"], num_samples=20, **CPU)
    assert len(caught) == 1 and res.samples["x"].shape == (4, 20, 3)


def test_fingerprints_are_the_references():
    rng = np.random.default_rng(0)
    tree = {"y": rng.normal(size=(5, 2)).astype(np.float32), "k": 3, "s": 0.5,
            "nested": {"b": rng.integers(0, 4, size=7).astype(np.int32), "a": None}}
    t_tree = {"y": torch.from_numpy(tree["y"]), "k": 3, "s": 0.5,
              "nested": {"b": torch.from_numpy(tree["nested"]["b"]), "a": None}}
    assert data_fingerprint(t_tree) == jckpt._data_fingerprint(tree)
    X = rng.normal(size=(50, 7)).astype(np.float32)
    y = (rng.random(50) < 0.5).astype(np.float32)
    for quantize in (None, "int8"):
        fused = prepare_fused_logistic_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y),
                                            quantize=quantize, device="cpu")
        j_fused = {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                       if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                       else jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v)
                   for k, v in fused.items()}
        assert data_fingerprint(fused) == jckpt._data_fingerprint(j_fused)
        assert data_fingerprint(fused)[0][0] == "['Xp']"
    assert data_fingerprint(None) is None


def test_warmup_guards_hold_both_ways():
    def vag(Z, data):
        return -0.5 * ((Z - data["mu"]) ** 2).sum(-1), -(Z - data["mu"])

    data = {"mu": torch.full((2,), 2.0)}
    ckpt = run_warmup(None, {"x": torch.zeros(2)}, num_warmup=30, stop=10, num_chains=2,
                      kernel="hmc", data=data, value_and_grad_fn=vag, **CPU)
    assert ckpt["callable_kwargs"] == ["value_and_grad_fn"]
    # the callable must come again
    with pytest.raises(ValueError, match="value_and_grad_fn"):
        resume_warmup(None, ckpt, stop=20, data=data, **CPU)
    # data the run had must come again; the reference checks only this way
    with pytest.raises(ValueError, match="fingerprint"):
        resume_warmup(None, ckpt, stop=20, value_and_grad_fn=vag, **CPU)
    resume_warmup(None, ckpt, stop=20, data=data, value_and_grad_fn=vag, **CPU)
    # and data the run did not have may not come
    plain = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=30, stop=10, num_chains=2,
                       kernel="hmc", **CPU)
    with pytest.raises(ValueError, match="fingerprint"):
        resume_warmup(_model, plain, stop=20, data=data, **CPU)


def test_sharded_and_orbax_raise(tmp_path):
    half = sample(_model, {"x": torch.zeros(2)}, num_samples=4, num_warmup=4, num_chains=2,
                  kernel="hmc", seed=0, **CPU)
    with pytest.raises(ValueError, match="npz"):
        save_checkpoint(str(tmp_path / "o"), half, backend="orbax")
    # the sharded paths (tests/test_torch_sharded_resume.py) take a DeviceMesh
    # of the checkpoint's layout: anything else raises, naming the caller
    with pytest.raises(TypeError, match="resume: mesh must be a torch.distributed DeviceMesh"):
        resume(_model, half, num_samples=4, mesh=object(), **CPU)
    with pytest.raises(TypeError, match="run_warmup: mesh must be"):
        run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=10, stop=5, mesh=object(), **CPU)
    ckpt = run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=10, stop=5, **CPU)
    with pytest.raises(TypeError, match="resume_warmup: mesh must be"):
        resume_warmup(_model, ckpt, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="resume_warmup: the mesh layout differs"):
        resume_warmup(_model, dict(ckpt, mesh_axes={"axis": "chains", "axis_size": 8}), **CPU)
    with pytest.raises(ValueError, match="apply to sharded runs only"):
        resume(_model, half, num_samples=4, log_prior_fn=_model, **CPU)
    os.makedirs(tmp_path / "dir")
    with pytest.raises(ValueError, match="npz"):
        load_checkpoint(str(tmp_path / "dir"))
    if not torch.cuda.is_available():
        for call in (lambda: resume(_model, half, num_samples=4),
                     lambda: run_warmup(_model, {"x": torch.zeros(2)}, num_warmup=10, stop=5),
                     lambda: resume_warmup(_model, ckpt)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
