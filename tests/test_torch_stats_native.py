"""The native R-hat and ESS (``csrc/fastdiag.c``, built with gcc at first
use) against the port's numpy path and the reference's, on the CPU.

The port of ``tests/test_diagnostics.py:94-136``, each case held to the
port's numpy path and to the reference's numpy path (``use_native=False``):
ESS within rtol 1e-6, R-hat within 1e-8. The automatic choice takes the
native engine from 2^18 elements up. With ``use_native=True`` a failed
build raises with the compiler's complaint; the automatic choice warns and
keeps numpy."""

import time

import numpy as np
import pytest

from mlx_mcmc_tpu.diagnostics import stats as jstats
from mlx_mcmc_tpu_torch import _build
from mlx_mcmc_tpu_torch.diagnostics import stats
from mlx_mcmc_tpu_torch.diagnostics.stats import effective_sample_size, potential_scale_reduction


def _ar1(rho, shape, rng):
    out = np.empty(shape)
    out[..., 0] = rng.normal(size=shape[:-1])
    innov_scale = np.sqrt(1 - rho**2)
    for t in range(1, shape[-1]):
        out[..., t] = rho * out[..., t - 1] + innov_scale * rng.normal(size=shape[:-1])
    return out


def test_ess_matches_numpy():
    rng = np.random.default_rng(0)
    x = _ar1(0.8, (4, 3000), rng)[..., None] * np.array([1.0, 2.0, 0.5])
    a = effective_sample_size(x, use_native=True)
    np.testing.assert_allclose(a, effective_sample_size(x, use_native=False), rtol=1e-6)
    np.testing.assert_allclose(a, jstats.effective_sample_size(x, use_native=False), rtol=1e-6)


def test_rhat_matches_numpy():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 1000, 5)) + np.arange(5) * 0.1
    a = potential_scale_reduction(x, use_native=True)
    np.testing.assert_allclose(a, potential_scale_reduction(x, use_native=False), rtol=1e-8)
    np.testing.assert_allclose(a, jstats.potential_scale_reduction(x, use_native=False),
                               rtol=1e-8)


def test_iid_scalar_param():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5000))
    a = effective_sample_size(x, use_native=True)
    assert np.shape(a) == ()
    assert 0.75 * 10000 < float(a) < 1.3 * 10000
    np.testing.assert_allclose(a, jstats.effective_sample_size(x, use_native=False), rtol=1e-6)
    r = potential_scale_reduction(x, use_native=True)
    assert np.shape(r) == ()
    np.testing.assert_allclose(r, jstats.potential_scale_reduction(x, use_native=False), rtol=1e-8)


def test_large_batch_faster_than_numpy():
    rng = np.random.default_rng(3)
    x = _ar1(0.5, (8, 2000), rng)[..., None] + rng.normal(size=(8, 2000, 200)) * 0.01
    effective_sample_size(x[:, :10, :2], use_native=True)  # the build, if any
    t0 = time.time()
    a = effective_sample_size(x, use_native=True)
    t_native = time.time() - t0
    t0 = time.time()
    b = effective_sample_size(x, use_native=False)
    t_numpy = time.time() - t0
    np.testing.assert_allclose(a, b, rtol=1e-5)
    # informational speed check; assert only that native is not absurd
    assert t_native < max(4 * t_numpy, 5.0)


def test_automatic_choice_takes_the_native_engine_for_large_inputs(monkeypatch):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 1024, 16)).cumsum(axis=1) * 0.05 + rng.normal(size=(16, 1024, 16))
    assert x.size >= stats._NATIVE_MIN_ELEMS
    calls = []
    native = stats._native
    monkeypatch.setattr(stats, "_native", lambda name, y: calls.append(name) or native(name, y))
    a = effective_sample_size(x)
    r = potential_scale_reduction(x)
    effective_sample_size(x[:, :100])  # below the threshold: numpy
    assert calls == ["fastdiag_ess", "fastdiag_rhat"]
    np.testing.assert_allclose(a, jstats.effective_sample_size(x, use_native=False), rtol=1e-6)
    np.testing.assert_allclose(r, jstats.potential_scale_reduction(x, use_native=False),
                               rtol=1e-8)


def test_short_chains_keep_the_numpy_rules():
    x = np.random.default_rng(5).normal(size=(3, 3, 2))
    assert np.isnan(effective_sample_size(x, use_native=True)).all()
    np.testing.assert_array_equal(potential_scale_reduction(x, use_native=True),
                                  potential_scale_reduction(x, use_native=False))


@pytest.fixture
def no_compiler(monkeypatch, tmp_path):
    """No gcc on PATH, no built library, no library loaded."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(stats, "_NATIVE_FAILED", [])


def test_use_native_raises_without_a_compiler(no_compiler):
    x = np.random.default_rng(6).normal(size=(4, 100, 2))
    with pytest.raises(RuntimeError, match="gcc"):
        effective_sample_size(x, use_native=True)
    with pytest.raises(RuntimeError, match="gcc"):
        potential_scale_reduction(x, use_native=True)
    # asked for numpy, numpy it is
    np.testing.assert_allclose(effective_sample_size(x, use_native=False),
                               jstats.effective_sample_size(x, use_native=False), rtol=1e-12)


def test_automatic_choice_warns_and_keeps_numpy_without_a_compiler(no_compiler):
    x = np.random.default_rng(7).normal(size=(16, 1024, 16))
    with pytest.warns(RuntimeWarning, match="native R-hat/ESS unavailable"):
        a = effective_sample_size(x)
    np.testing.assert_allclose(a, jstats.effective_sample_size(x, use_native=False), rtol=1e-12)
