"""Port parity of ChEES-HMC (``kernels/chees.py``) and its paths through
``sample()`` and the facade, after ``tests/test_chees.py``.

- ``halton_sequence`` (host) and ``halton_device`` give the reference's
  float32 bits for every global step below 70,000 (past 2^16, where the
  16-bit radical inverse wraps).
- The leapfrog count ``clip(ceil(trajectory_length / eps), 1, max)``
  equals the reference kernel's ``num_integration_steps`` over a sweep of
  lengths and step sizes, exact multiples, both clips, inf and NaN.
- One transition at n in {1, 3, 8} leapfrogs, replayed from JAX's draws
  for 32 chains as ``tests/test_torch_hmc.py`` does: flags and counts
  exactly, the new state, accept statistic and energy to 1e-5 relative,
  the endpoint fields of the chains that did not diverge to 1e-5 relative
  plus 1e-5 of the field's largest magnitude.
- ``chees_gradient`` and ``trajectory_update`` against the reference's on
  the same inputs to 1e-6 relative (float32; means over chains in another
  order).
- The reference's oracles on the CPU (all but the sharded one, ROADMAP
  A.10), through a closed-form value+grad where the model is a Gaussian
  (the same sampler, a tenth of autograd's cost a leapfrog).
The transition through ``graphs.GraphedTrajectory`` is held to the eager
one bit for bit in ``test_torch_capture.py``: with an emulated capture on
the CPU, and by a ``cuda`` test on the card (that file imports no JAX, so
it runs where JAX is absent).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.kernels.base import Tunables as JTunables
from mlx_mcmc_tpu.kernels.chees import (
    chees_gradient as j_chees_gradient,
    halton_sequence as j_halton_sequence,
    make_chees_kernel as j_make_chees_kernel,
    trajectory_init as j_trajectory_init,
    trajectory_update as j_trajectory_update,
)
from mlx_mcmc_tpu.models import eight_schools as j_eight_schools
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch import MCMC, Normal, sample
from mlx_mcmc_tpu_torch.convert import (
    chees_info_from_jax,
    hmc_state_from_jax,
    trajectory_state_from_jax,
    tunables_from_jax,
)
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.chees import (
    chees_gradient,
    halton_device,
    halton_sequence,
    make_chees_kernel,
    num_leapfrogs,
    trajectory_init,
    trajectory_update,
)
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
from mlx_mcmc_tpu_torch.kernels.integrators import sample_momentum
from mlx_mcmc_tpu_torch.models import eight_schools
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

C = 32
RTOL = 1e-5


def test_halton_bits_match_the_reference():
    t = np.arange(70_000)
    ref = np.asarray(jax.jit(jax.vmap(j_halton_sequence))(jnp.asarray(t, jnp.int32)))
    assert ref.dtype == np.float32
    host = np.array([halton_sequence(int(i)) for i in t], np.float32)
    np.testing.assert_array_equal(host, ref)
    np.testing.assert_array_equal(halton_device(torch.from_numpy(t)).numpy(), ref)
    np.testing.assert_allclose(host[:4], [0.5, 0.25, 0.75, 0.125])


def test_count_formula_matches_the_reference():
    rng = np.random.default_rng(0)
    max_steps = 40
    eps = np.exp(rng.uniform(-4, 1, 400)).astype(np.float32)
    length = (eps * rng.uniform(0, 50, 400)).astype(np.float32)
    whole = np.arange(1, 51, dtype=np.float32)
    # exact multiples, the clips, zero, inf and NaN
    eps = np.concatenate([eps, np.full(50, 0.125, np.float32), [0.1, 0.1, 0.1, 0.1, 0.0, 0.1]])
    length = np.concatenate([length, whole * np.float32(0.125),
                             [0.0, 1e-30, 1e30, np.inf, 1.0, np.nan]]).astype(np.float32)
    j_init, j_step = j_make_chees_kernel(lambda z: -0.5 * jnp.sum(z * z),
                                         max_leapfrog_steps=max_steps)
    state = j_init(jnp.zeros(1))

    def count(e, tl):
        tun = JTunables(step_size=e, inv_mass_diag=jnp.ones(1), trajectory_length=tl)
        return j_step(jax.random.PRNGKey(0), state, tun)[1].num_integration_steps

    ref = np.asarray(jax.jit(jax.vmap(count))(jnp.asarray(eps), jnp.asarray(length)))
    got = num_leapfrogs(torch.from_numpy(length), torch.from_numpy(eps), max_steps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.min() == 1 and ref.max() == max_steps


def _gaussian_problem(rng):
    dim = 6
    scales = np.linspace(0.5, 2.0, dim).astype(np.float32)

    def j_lp(params):
        return jnp.sum(-0.5 * (params["x"] / scales) ** 2)

    def t_lp(params):
        return torch.sum(-0.5 * (params["x"] / torch.from_numpy(scales)) ** 2)

    init = {"x": np.zeros(dim, np.float32)}
    jflp, _, _ = j_make_flat_logprob(j_lp, init)
    tflp, _, _ = make_flat_logprob(t_lp, init, device="cpu")
    z0 = rng.standard_normal((C, dim)).astype(np.float32)
    return jflp, make_batched_value_and_grad(tflp), z0, 0.6


def _schools_problem(rng):
    jspec = j_eight_schools(centered=True)
    tspec = eight_schools(centered=True, device="cpu")
    jflp, _, _ = j_make_flat_logprob(jspec.log_prob, jspec.initial_params)
    tflp, _, _ = make_flat_logprob(tspec.log_prob, tspec.initial_params, device="cpu")
    z0 = (0.5 * rng.standard_normal((C, 10))).astype(np.float32)
    return jflp, make_batched_value_and_grad(tflp), z0, 0.3


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("problem", [_gaussian_problem, _schools_problem],
                         ids=["gaussian", "schools"])
def test_one_transition_matches_jax(problem, n):
    rng = np.random.default_rng(5)
    jflp, tvag, z0, eps = problem(rng)
    dim = z0.shape[1]
    j_init, j_step = j_make_chees_kernel(jflp)
    inv_mass = (0.5 + rng.random(dim)).astype(np.float32)
    length = np.float32((n - 0.5) * eps)
    j_tun = JTunables(step_size=jnp.asarray(eps, jnp.float32), inv_mass_diag=jnp.asarray(inv_mass),
                      trajectory_length=jnp.asarray(length))
    j_states = jax.vmap(j_init)(jnp.asarray(z0))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    j_new, j_info = jax.jit(jax.vmap(j_step, in_axes=(0, 0, None)))(keys, j_states, j_tun)

    def draws(key):  # chees.py:125-126, 139
        key_momentum, key_accept = jax.random.split(key)
        return (jax.random.normal(key_momentum, (dim,), jnp.float32),
                jax.random.uniform(key_accept, (), jnp.float32))

    normals, u = jax.vmap(draws)(keys)
    t_tun = tunables_from_jax(j_tun, device="cpu")
    count = int(num_leapfrogs(torch.tensor(length), t_tun.step_size, 1000))
    assert count == n
    r0 = sample_momentum(torch.tensor(np.asarray(normals)), t_tun.inv_mass_diag)
    U = torch.zeros((C, 1, 4))
    U[:, 0, 0] = torch.tensor(np.asarray(u))
    _, t_step = make_chees_kernel(tvag)
    t_new, t_info, syncs = t_step(hmc_state_from_jax(j_states, device="cpu"), t_tun, r0, U, count)

    assert syncs == 0
    np.testing.assert_array_equal(t_info.is_accepted.numpy(), np.asarray(j_info.is_accepted))
    np.testing.assert_array_equal(t_info.is_divergent.numpy(), np.asarray(j_info.is_divergent))
    assert (t_info.num_integration_steps == n).all() and (np.asarray(j_info.num_integration_steps) == n).all()
    for t, j in [(t_new.position, j_new.position), (t_new.log_prob, j_new.log_prob),
                 (t_new.grad, j_new.grad), (t_info.accept_prob, j_info.accept_prob),
                 (t_info.energy, j_info.energy)]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=RTOL)
    # The trajectory's end, accepted or not: a divergent trajectory amplifies
    # float32 rounding (in the centered funnel at n = 8, 3 of 32 chains
    # diverge and are rejected), so the endpoint fields are held on the
    # chains that did not diverge, to 1e-5 relative plus 1e-5 of the field's
    # largest magnitude (the funnel's ends reach |z| ~ 90).
    ok = ~t_info.is_divergent.numpy()
    for t, j in [(t_info.proposal_position, j_info.proposal_position),
                 (t_info.end_velocity, j_info.end_velocity)]:
        j = np.asarray(j)[ok]
        np.testing.assert_allclose(t.numpy()[ok], j, rtol=RTOL, atol=RTOL * np.abs(j).max())
    if n > 1:  # both outcomes occur
        assert 0 < int(t_info.is_accepted.sum()) < C


def test_step_refuses_a_count_outside_its_range():
    _, step = make_chees_kernel(lambda Z: (-0.5 * (Z * Z).sum(-1), -Z), max_leapfrog_steps=5)
    z = torch.zeros(2, 1)
    state = HMCState(z, torch.zeros(2), z)
    tun = Tunables(torch.tensor(0.1), torch.ones(1))
    for n in (0, 6):
        with pytest.raises(ValueError, match="num_steps"):
            step(state, tun, z, torch.full((2, 1, 4), 0.5), n)


def test_gradient_and_trajectory_update_match_the_reference():
    rng = np.random.default_rng(2)
    dim = 7
    j_init, j_step = j_make_chees_kernel(lambda z: -0.5 * jnp.sum(z * z / jnp.arange(1.0, 8.0)))
    z0 = rng.standard_normal((C, dim)).astype(np.float32)
    j_tun = JTunables(step_size=jnp.asarray(0.4, jnp.float32), inv_mass_diag=jnp.ones(dim),
                      trajectory_length=jnp.asarray(2.0, jnp.float32))
    states = jax.vmap(j_init)(jnp.asarray(z0))
    _, infos = jax.vmap(j_step, in_axes=(0, 0, None))(
        jax.random.split(jax.random.PRNGKey(1), C), states, j_tun)
    jitter = j_halton_sequence(jnp.asarray(37))
    j_grad = j_chees_gradient(jnp.asarray(z0), infos, jitter)
    t_grad = chees_gradient(torch.from_numpy(z0), chees_info_from_jax(infos, device="cpu"),
                            halton_sequence(37))
    np.testing.assert_allclose(float(t_grad), float(j_grad), rtol=1e-6)

    j_state = j_trajectory_init(0.4)
    t_state = trajectory_init(0.4)
    for k, g in enumerate([float(j_grad), -3.0, 0.5, 2e7, -1e-3, 40.0]):
        eps = np.float32(0.4 * (1 + 0.1 * k))
        j_state = j_trajectory_update(j_state, jnp.asarray(g, jnp.float32), jnp.asarray(eps),
                                      max_leapfrog_steps=20)
        t_state = trajectory_update(t_state, torch.tensor(g, dtype=torch.float32),
                                    torch.tensor(eps), max_leapfrog_steps=20)
        for a, b in zip(t_state, trajectory_state_from_jax(j_state, device="cpu")):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-12)


def _std_normal(params):
    return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))


def _gaussian_vag(prec):
    """The closed-form value+grad of ``-0.5 z^T prec z``, batched."""
    prec = torch.as_tensor(prec, dtype=torch.float32)

    def vag(Z):
        g = -Z @ prec
        return 0.5 * (Z * g).sum(-1), g

    return vag


RUN = dict(kernel="chees", device="cpu")


def test_recovers_standard_normal():
    res = sample(None, {"x": torch.zeros(5)}, value_and_grad_fn=_gaussian_vag(torch.eye(5)),
                 num_samples=2000, num_warmup=1000, num_chains=8, seed=0, **RUN)
    xs = res.samples["x"].numpy().reshape(-1, 5)
    assert np.all(np.abs(xs.mean(axis=0)) < 0.1)
    assert np.all(np.abs(xs.std(axis=0) - 1.0) < 0.1)
    assert res.diagnostics()["x"]["r_hat"] < 1.05


def test_uniform_cost_across_chains():
    res = sample(_std_normal, {"x": torch.zeros(3)}, num_samples=50, num_warmup=100,
                 num_chains=8, seed=1, **RUN)
    steps = res.info.num_integration_steps.numpy()  # (chains, draws)
    assert (steps == steps[0:1, :]).all()
    assert len(np.unique(steps[0])) > 3  # jittered
    # one count read per warmup step and one for the draws, beside the probe's
    assert len(res.leapfrog_counts) == 150 and list(res.leapfrog_counts[100:]) == steps[0].tolist()
    assert res.host_syncs > 101


def test_trajectory_adapts_up_for_correlated_target():
    prec = np.array([[1.0, -0.97], [-0.97, 1.0]]) / (1 - 0.97**2)
    res = sample(None, {"x": torch.zeros(2)}, value_and_grad_fn=_gaussian_vag(prec),
                 num_samples=1500, num_warmup=1500, num_chains=16, seed=0, **RUN)
    eps = float(res.tunables.step_size)
    tau = float(res.tunables.trajectory_length)
    assert tau > 2 * eps  # grew beyond the 1-step init
    cov = np.cov(res.samples["x"].numpy().reshape(-1, 2).T)
    true_cov = np.linalg.inv(prec)
    np.testing.assert_allclose(cov, true_cov, atol=0.2 * true_cov[0, 0])


def test_reproducible_fixed_seed_and_extras_stripped():
    kw = dict(num_samples=100, num_warmup=100, num_chains=4, seed=9, **RUN)
    a = sample(_std_normal, {"x": torch.zeros(2)}, **kw)
    b = sample(_std_normal, {"x": torch.zeros(2)}, **kw)
    assert torch.equal(a.samples["x"], b.samples["x"])
    # the endpoint fields are not stored per draw
    assert tuple(a.info.proposal_position.shape) == (4, 100, 0)
    assert tuple(a.info.end_velocity.shape) == (4, 100, 0)
    assert math.isfinite(float(a.tunables.trajectory_length))


def test_facade_method():
    mcmc = MCMC(_std_normal)
    samples = mcmc.run({"x": torch.zeros(2)}, num_samples=200, num_warmup=200, method="chees",
                       verbose=False, device="cpu")
    assert samples["x"].shape == (200, 2)
