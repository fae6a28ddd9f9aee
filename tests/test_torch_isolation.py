"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points refuse to fall back to the CPU without being asked."""

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
             "mlx_mcmc_tpu_torch.ops.suffstats",
             "mlx_mcmc_tpu_torch.benchmarks.glm_kernel_variants",
             "mlx_mcmc_tpu_torch.benchmarks.flagship_decomposition"):
    assert name in names, name
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
    assert count >= 15  # every module of the slice was imported


def test_sample_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    from mlx_mcmc_tpu_torch import sample
    from mlx_mcmc_tpu_torch.ops.glm import prepare_fused_logistic_data

    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample(lambda p: -(p["x"] ** 2).sum(), {"x": [0.0]}, num_samples=2, num_warmup=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_fused_logistic_data([[1.0]], [1.0])


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
