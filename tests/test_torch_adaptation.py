"""Port parity: warmup schedule, dual averaging + Welford adaptation replay,
and the step-size search, against JAX (tolerance 1e-6 relative: float32 in
the same order, reductions over chains aside)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.kernels import adaptation as ja
from mlx_mcmc_tpu_torch.convert import adaptation_state_from_jax
from mlx_mcmc_tpu_torch.kernels import adaptation as ta

TOL = 1e-6


@pytest.mark.parametrize("num_warmup", [0, 10, 19, 20, 50, 149, 150, 300, 1000, 2500])
def test_build_schedule_matches_jax(num_warmup):
    t = ta.build_schedule(num_warmup)
    j = ja.build_schedule(num_warmup)
    np.testing.assert_array_equal(t.in_slow_window, j.in_slow_window)
    np.testing.assert_array_equal(t.window_end, j.window_end)
    off = ta.build_schedule(num_warmup, adapt_mass_matrix=False)
    assert not off.in_slow_window.any() and not off.window_end.any()


def _assert_state(t_state, j_state):
    conv = adaptation_state_from_jax(j_state, device="cpu")
    for a, b in zip(
        list(t_state.da) + list(t_state.welford) + [t_state.inv_mass_diag],
        list(conv.da) + list(conv.welford) + [conv.inv_mass_diag],
    ):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=TOL, atol=TOL)


def test_adaptation_update_replay_matches_jax():
    rng = np.random.default_rng(0)
    num_warmup, chains, dim = 200, 16, 4
    sched = ja.build_schedule(num_warmup)
    assert sched.window_end.sum() >= 2
    t_state = ta.adaptation_init(dim, 0.37, device="cpu")
    j_state = ja.adaptation_init(dim, 0.37)
    _assert_state(t_state, j_state)
    scales = np.array([0.5, 1.0, 2.0, 4.0], np.float32)
    for t in range(num_warmup):
        accept = rng.random(chains).astype(np.float32)
        pos = (scales * rng.standard_normal((chains, dim))).astype(np.float32)
        j_state = ja.adaptation_update(
            j_state, jnp.mean(jnp.asarray(accept)), jnp.asarray(pos),
            jnp.asarray(sched.in_slow_window[t]), jnp.asarray(sched.window_end[t]), 0.8,
        )
        t_state = ta.adaptation_update(
            t_state, torch.from_numpy(accept).mean(), torch.from_numpy(pos),
            bool(sched.in_slow_window[t]), bool(sched.window_end[t]), 0.8,
        )
        _assert_state(t_state, j_state)
    # The mass matrix moved off the identity toward the position variances.
    assert float(t_state.inv_mass_diag[3]) > 4.0 * float(t_state.inv_mass_diag[0])


@pytest.mark.parametrize("scale,init", [(1.0, 1.0), (0.01, 1.0), (30.0, 0.001)])
def test_find_reasonable_step_size_matches_jax(scale, init):
    # A smooth accept curve crossing 0.5 at eps = scale.
    def t_fn(eps):
        return float(np.float32(np.exp(np.float32(-np.log(2.0)) * np.float32(eps / scale) ** 2)))

    def j_fn(eps):
        return jnp.exp(jnp.float32(-np.log(2.0)) * (eps / scale) ** 2)

    eps_t, probes = ta.find_reasonable_step_size(t_fn, init_step_size=init)
    eps_j = float(ja.find_reasonable_step_size(j_fn, init_step_size=init))
    assert eps_t == pytest.approx(eps_j, rel=TOL)
    assert probes >= 2
    # Power-of-two moves from the initial value.
    assert np.log2(eps_t / init) == pytest.approx(round(np.log2(eps_t / init)))
