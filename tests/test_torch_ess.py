"""Port parity: device ESS and split R-hat with torch.fft against JAX's
``diagnostics/device.py`` (rtol 1e-4: float32 FFTs of different libraries),
and the port's numpy copy of ``diagnostics/stats.py`` against the original
(numpy path, 1e-10)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.diagnostics import device as jdev
from mlx_mcmc_tpu.diagnostics import stats as jstats
from mlx_mcmc_tpu_torch.diagnostics import device as tdev
from mlx_mcmc_tpu_torch.diagnostics import stats as tstats


def _ar1(chains, draws, params, phi, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros((chains, draws, params))
    eps = rng.standard_normal((chains, draws, params))
    for t in range(1, draws):
        x[:, t] = phi * x[:, t - 1] + eps[:, t]
    x += rng.standard_normal((chains, 1, params)) * 0.1  # chain offsets
    return x.astype(np.float32)


@pytest.mark.parametrize("phi", [0.0, 0.5, 0.9])
def test_device_ess_and_rhat_match_jax(phi):
    x = _ar1(8, 201, 3, phi)
    np.testing.assert_allclose(
        tdev.device_ess(torch.from_numpy(x)).numpy(),
        np.asarray(jdev.device_ess(jnp.asarray(x))), rtol=1e-4,
    )
    np.testing.assert_allclose(
        tdev.device_rhat(torch.from_numpy(x)).numpy(),
        np.asarray(jdev.device_rhat(jnp.asarray(x))), rtol=1e-4,
    )


def test_chunked_ess_upcasts_slices_and_matches():
    x = torch.from_numpy(_ar1(6, 100, 7, 0.6, seed=1))
    whole = tdev.device_ess(x)
    # A budget that forces one parameter per slice.
    chunked = tdev.device_ess_chunked(x, max_bytes=6 * 256 * 8)
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), rtol=1e-6)
    from_bf16 = tdev.device_ess_chunked(x.bfloat16())
    assert from_bf16.dtype == torch.float32
    np.testing.assert_allclose(from_bf16.numpy(), whole.numpy(), rtol=0.05)


def test_numpy_stats_copy_matches_reference():
    x = _ar1(4, 150, 2, 0.7, seed=2).astype(np.float64)
    np.testing.assert_allclose(
        tstats.effective_sample_size(x), jstats.effective_sample_size(x, use_native=False),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        tstats.potential_scale_reduction(x),
        jstats.potential_scale_reduction(x, use_native=False), rtol=1e-10,
    )
    assert tstats.summary_stats(x[..., 0]) == pytest.approx(jstats.summary_stats(x[..., 0]))
