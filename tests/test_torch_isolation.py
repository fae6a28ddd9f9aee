"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points refuse to fall back to the CPU without being asked."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
import mlx_mcmc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mlx_mcmc_tpu_torch.__path__, "mlx_mcmc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("mlx_mcmc_tpu_torch.ops.glm_variants", "mlx_mcmc_tpu_torch.models.jax_random",
             "mlx_mcmc_tpu_torch.ops.suffstats", "mlx_mcmc_tpu_torch.inference.mcmc",
             "mlx_mcmc_tpu_torch.kernels.metropolis", "mlx_mcmc_tpu_torch.kernels.legacy",
             "mlx_mcmc_tpu_torch.distributions.transforms",
             "mlx_mcmc_tpu_torch.distributions.categorical",
             "mlx_mcmc_tpu_torch.distributions.beta", "mlx_mcmc_tpu_torch.distributions.gamma",
             "mlx_mcmc_tpu_torch.benchmarks.glm_kernel_variants",
             "mlx_mcmc_tpu_torch.benchmarks.flagship_decomposition",
             "mlx_mcmc_tpu_torch.kernels.chees", "mlx_mcmc_tpu_torch.kernels.mala",
             "mlx_mcmc_tpu_torch.inference.init_strategies",
             "mlx_mcmc_tpu_torch.distributions.extras", "mlx_mcmc_tpu_torch.utils.config",
             "mlx_mcmc_tpu_torch.io.checkpoint", "mlx_mcmc_tpu_torch.inference.vi",
             "mlx_mcmc_tpu_torch.inference.tempered", "mlx_mcmc_tpu_torch.inference.ensemble",
             "mlx_mcmc_tpu_torch.inference.smc", "mlx_mcmc_tpu_torch.inference.api",
             "mlx_mcmc_tpu_torch.diagnostics.model_comparison",
             "mlx_mcmc_tpu_torch.utils.roofline", "mlx_mcmc_tpu_torch.utils.profiling",
             "mlx_mcmc_tpu_torch.benchmarks.nuts_overhead",
             "mlx_mcmc_tpu_torch.benchmarks.flagship_breakdown",
             "mlx_mcmc_tpu_torch.benchmarks.poisson_roofline",
             "mlx_mcmc_tpu_torch.benchmarks.run_all"):
    assert name in names, name
from mlx_mcmc_tpu_torch import (MCMC, sample, metropolis_hastings, hmc, nuts, Normal, HalfNormal,
                                Beta, Gamma, Exponential, Categorical, make_transformed_logprob,
                                Bernoulli, Binomial, NegativeBinomial, Laplace, Cauchy, Uniform,
                                LogNormal, StudentT, Poisson, Dirichlet, MultivariateNormal)
from mlx_mcmc_tpu_torch.utils import (SamplerConfig, AdaptationConfig, MeshConfig, trace_to,
                                      gradient_evals, device_peaks, glm_vag_flops,
                                      glm_vag_bytes, roofline_report)
from mlx_mcmc_tpu_torch.kernels import (TransitionInfo, Tunables, identity_tunables,
                                        MetropolisState, HMCState, MALAState, ChEESInfo,
                                        make_metropolis_kernel, make_hmc_kernel,
                                        make_mala_kernel, make_nuts_kernel, make_chees_kernel,
                                        metropolis_hastings, hmc, nuts)
from mlx_mcmc_tpu_torch.ops import (ravel_params, make_flat_logprob, WelfordState, welford_init,
                                    welford_update, welford_batch_update, welford_finalize,
                                    safe_where_log_prob)
from mlx_mcmc_tpu_torch import ADVIResult, fit_advi
from mlx_mcmc_tpu_torch import (sample_tempered, TemperedResult, sample_ensemble, sample_smc,
                                SMCResult, sample_posterior_predictive)
from mlx_mcmc_tpu_torch.inference import (MCMC, MCMCResult, sample, sample_posterior_predictive,
                                          clear_runner_cache, build_sampler, make_kernel,
                                          TemperedResult, geometric_ladder, sample_tempered,
                                          ADVIResult, fit_advi, sample_ensemble, SMCResult,
                                          sample_smc)
from mlx_mcmc_tpu_torch.diagnostics import (effective_sample_size, potential_scale_reduction,
                                            summary_stats, device_ess, device_rhat, compare,
                                            pointwise_log_likelihood, psis_loo, waic)
from mlx_mcmc_tpu_torch.io import (save_checkpoint, load_checkpoint, resume, run_warmup,
                                   resume_warmup)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mlx_mcmc_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    count = int(out.stdout.split()[0])
    assert count >= 25  # every module of the slice was imported


_EXPORTS_PROBE = """
import json, sys
import torch
import mlx_mcmc_tpu_torch.kernels as k, mlx_mcmc_tpu_torch.ops as o, mlx_mcmc_tpu_torch.utils as u
from mlx_mcmc_tpu_torch import _build
for p in (k, o, u):
    assert all(hasattr(p, n) for n in p.__all__), p
assert not _build._LOADED, _build._LOADED  # no library built or loaded
assert not torch.cuda.is_initialized()  # no card touched
print(json.dumps({"kernels": k.__all__, "ops": o.__all__, "utils": u.__all__}))
"""


@pytest.fixture(scope="module")
def exports():
    out = subprocess.run([sys.executable, "-c", _EXPORTS_PROBE], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    return json.loads(out.stdout)


@pytest.mark.parametrize("package", ["kernels", "ops", "utils"])
def test_exports_are_the_references(exports, package):
    # importing the exports builds no library and touches no card
    ref = __import__(f"mlx_mcmc_tpu.{package}", fromlist=["__all__"])
    assert sorted(exports[package]) == sorted(ref.__all__)


def test_kernel_exports_behave_as_the_references():
    from mlx_mcmc_tpu.kernels import identity_tunables as j_identity_tunables
    from mlx_mcmc_tpu_torch.kernels import hmc, identity_tunables, nuts

    assert callable(nuts) and callable(hmc)  # the free functions, not the modules
    tun, ref = identity_tunables(3, 0.25, device="cpu"), j_identity_tunables(3, 0.25)
    assert tun.step_size.dtype == torch.float32 and tun.step_size.dim() == 0
    assert float(tun.step_size) == float(ref.step_size)
    assert tun.inv_mass_diag.tolist() == list(map(float, ref.inv_mass_diag))
    assert tun.trajectory_length == ref.trajectory_length == 1.0


def test_sample_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from mlx_mcmc_tpu_torch import sample
    from mlx_mcmc_tpu_torch.ops.glm import prepare_fused_logistic_data

    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample(lambda p: -(p["x"] ** 2).sum(), {"x": [0.0]}, num_samples=2, num_warmup=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_fused_logistic_data([[1.0]], [1.0])
    from mlx_mcmc_tpu_torch import MCMC, metropolis_hastings

    with pytest.raises(RuntimeError, match="no CUDA device"):
        MCMC(lambda p: -(p["x"] ** 2).sum()).run({"x": [0.0]}, num_samples=2, num_warmup=2,
                                                  method="hmc", verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metropolis_hastings(lambda p: -(p["x"] ** 2).sum(), {"x": [0.0]}, num_samples=2)
    from mlx_mcmc_tpu_torch import fit_advi
    from mlx_mcmc_tpu_torch.io import resume, resume_warmup, run_warmup

    def model(p):
        return -(p["x"] ** 2).sum()

    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_advi(model, {"x": [0.0]}, num_steps=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_warmup(model, {"x": [0.0]}, num_warmup=4, stop=2)
    # a sampling and a warmup checkpoint, made on the CPU, resumed without
    # device=
    done = sample(model, {"x": [0.0]}, num_samples=2, num_warmup=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resume(model, done, num_samples=2)
    half = run_warmup(model, {"x": [0.0]}, num_warmup=4, stop=2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resume_warmup(model, half, num_samples=2)


_JAX_RANDOM_PROBE = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("jax_random", "mlx_mcmc_tpu_torch/models/jax_random.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
key = mod.split(mod.prng_key(0), 3)[0]
assert mod.normal(key, (3, 4)).shape == (3, 4)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "mlx_mcmc_tpu", "torch"))
assert not bad, bad
"""


def test_reference_streams_need_numpy_only():
    # models/jax_random.py reproduces jax.random's streams with numpy alone.
    out = subprocess.run(
        [sys.executable, "-c", _JAX_RANDOM_PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
