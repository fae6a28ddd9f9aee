"""Port parity of HMC (``kernels/hmc.py``) and its paths through
``sample()``, after ``tests/test_hmc.py``.

One transition replayed from JAX's random draws: for 32 chains the
reference's per-chain ``step_fn`` runs under ``vmap``; the port's batched
``step_fn`` gets the same momenta and accept uniform (drawn exactly as
``mlx_mcmc_tpu/kernels/hmc.py:51-71`` draws them). Accept and divergence
flags must match exactly; position, log_prob, grad, accept_prob and energy
to 1e-5 relative (float32 arithmetic, reduction order differs; the
trajectories are 8 leapfrogs long).

Then the reference's oracles at small sizes on the CPU: moment recovery,
adaptation, a fixed step size, the HalfNormal constraint, the legacy
signature, ``thin`` and layout invariance with ``jitter``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.kernels.base import Tunables as JTunables
from mlx_mcmc_tpu.kernels.hmc import make_hmc_kernel as j_make_hmc_kernel
from mlx_mcmc_tpu.models import eight_schools as j_eight_schools
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch import HalfNormal, Normal, hmc, nuts, sample
from mlx_mcmc_tpu_torch.convert import hmc_state_from_jax, tunables_from_jax
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState, make_hmc_kernel
from mlx_mcmc_tpu_torch.kernels.integrators import sample_momentum
from mlx_mcmc_tpu_torch.models import eight_schools
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

C = 32
L = 8
RTOL = 1e-5


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


@pytest.mark.parametrize("problem", [_gaussian_problem, _schools_problem],
                         ids=["gaussian", "schools"])
def test_one_transition_matches_jax(problem):
    rng = np.random.default_rng(5)
    jflp, tvag, z0, eps = problem(rng)
    dim = z0.shape[1]
    j_init, j_step = j_make_hmc_kernel(jflp, num_leapfrog_steps=L)
    inv_mass = (0.5 + rng.random(dim)).astype(np.float32)
    j_tun = JTunables(step_size=jnp.asarray(eps, jnp.float32), inv_mass_diag=jnp.asarray(inv_mass))
    j_states = jax.vmap(j_init)(jnp.asarray(z0))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    j_new, j_info = jax.jit(jax.vmap(j_step, in_axes=(0, 0, None)))(keys, j_states, j_tun)

    def draws(key):  # hmc.py:51-52, 70
        key_momentum, key_accept = jax.random.split(key)
        return (jax.random.normal(key_momentum, (dim,), jnp.float32),
                jax.random.uniform(key_accept, (), jnp.float32))

    normals, u = jax.vmap(draws)(keys)
    t_tun = tunables_from_jax(j_tun, device="cpu")
    r0 = sample_momentum(torch.tensor(np.asarray(normals)), t_tun.inv_mass_diag)
    U = torch.zeros((C, 1, 4))
    U[:, 0, 0] = torch.tensor(np.asarray(u))
    _, t_step = make_hmc_kernel(tvag, num_leapfrog_steps=L)
    t_new, t_info, syncs = t_step(hmc_state_from_jax(j_states, device="cpu"), t_tun, r0, U)

    assert syncs == 0
    np.testing.assert_array_equal(t_info.is_accepted.numpy(), np.asarray(j_info.is_accepted))
    np.testing.assert_array_equal(t_info.is_divergent.numpy(), np.asarray(j_info.is_divergent))
    assert (t_info.num_integration_steps == L).all() and (t_info.tree_depth == 0).all()
    for t, j in [(t_new.position, j_new.position), (t_new.log_prob, j_new.log_prob),
                 (t_new.grad, j_new.grad), (t_info.accept_prob, j_info.accept_prob),
                 (t_info.energy, j_info.energy)]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=RTOL)
    # both outcomes occur
    assert 0 < int(t_info.is_accepted.sum()) < C


def test_nan_energy_is_rejected_and_divergent():
    def vag(Z):
        bad = Z[:, 0] > 0.5
        ll = torch.where(bad, torch.nan, -0.5 * (Z * Z).sum(-1))
        return ll, -Z

    _, step = make_hmc_kernel(vag, num_leapfrog_steps=3)
    z0 = torch.tensor([[0.0, 0.0], [0.4, 0.0]])
    ll, g = vag(z0)
    r0 = torch.tensor([[0.0, 0.0], [1.0, 0.0]])
    U = torch.full((2, 1, 4), 0.5)
    new, info, _ = step(HMCState(z0, ll, g), Tunables(torch.tensor(0.2), torch.ones(2)), r0, U)
    assert info.is_accepted.tolist() == [True, False]
    assert info.is_divergent.tolist() == [False, True]
    assert float(info.accept_prob[1]) == 0.0
    assert torch.equal(new.position[1], z0[1])


def _standard_normal_2d(params):
    return Normal(0.0, 1.0).log_prob(params["a"]) + Normal(0.0, 1.0).log_prob(params["b"])


RUN = dict(kernel="hmc", device="cpu", num_leapfrog_steps=5)


def test_recovers_standard_normal_with_adaptation():
    res = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_samples=400, num_warmup=150,
                 num_chains=8, seed=0, **RUN)
    for name in ("a", "b"):
        xs = res.samples[name].numpy().ravel()
        assert abs(xs.mean()) < 0.1 and abs(xs.std() - 1.0) < 0.1
    # dual averaging toward 0.8 (the reference's hmc target)
    assert abs(float(res.info.accept_prob.mean()) - 0.8) < 0.1
    assert 0.6 < res.acceptance_rate <= 1.0
    assert res.divergences == 0 and res.host_syncs > 0  # the probe's reads
    assert torch.isfinite(res.info.energy).all() and torch.isfinite(res.info.log_prob).all()


def test_bad_step_size_adapts_and_fixed_one_is_kept():
    res = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_samples=100, num_warmup=150,
                 num_chains=4, seed=2, step_size=5.0, **RUN)
    assert res.acceptance_rate > 0.5 and float(res.tunables.step_size) < 5.0
    fixed = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_samples=50, num_warmup=50,
                   seed=2, step_size=0.3, adapt_step_size=False, adapt_mass_matrix=False, **RUN)
    assert float(fixed.tunables.step_size) == np.float32(0.3)
    assert torch.equal(fixed.tunables.inv_mass_diag, torch.ones(2))
    assert (fixed.info.step_size == np.float32(0.3)).all()
    assert fixed.host_syncs == 0  # no probe, and an HMC step reads nothing


def test_halfnormal_constraint_stays_positive():
    res = sample(lambda p: HalfNormal(2.0).log_prob(p["s"]), {"s": 1.0}, num_samples=400,
                 num_warmup=200, num_chains=4, seed=0, **RUN)
    assert (res.samples["s"] > 0).all()


def test_bit_reproducible_and_legacy_signature():
    kw = dict(num_samples=40, num_warmup=40, seed=42, **RUN)
    a = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, **kw)
    b = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, **kw)
    assert torch.equal(a.samples["a"], b.samples["a"])
    samples, accept = hmc(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_samples=60,
                          num_warmup=60, num_leapfrog_steps=4, key=7, device="cpu")
    assert samples["a"].shape == (60,) and isinstance(samples["a"], np.ndarray)
    assert 0.0 < accept <= 1.0
    samples, accept = nuts(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_samples=40,
                           num_warmup=40, max_tree_depth=4, key=7, device="cpu")
    assert samples["b"].shape == (40,) and 0.0 < accept <= 1.0


def test_thin_stores_block_ends_and_aggregates():
    """Stored draw j of a thin=3 run is step num_warmup + 3j + 2 of the
    dense run (the same per-step draws); divergences are the block's any
    and integration steps its sum."""
    def funnel(params):
        y, x = params["y"], params["x"]
        return Normal(0.0, 3.0).log_prob(y) + torch.sum(Normal(0.0, torch.exp(0.5 * y)).log_prob(x))

    kw = dict(num_warmup=5, num_chains=4, seed=3, step_size=1.5, adapt_step_size=False,
              adapt_mass_matrix=False, **RUN)
    init = {"y": 0.0, "x": torch.zeros(3)}
    dense = sample(funnel, init, num_samples=60, **kw)
    thinned = sample(funnel, init, num_samples=20, thin=3, **kw)
    assert thinned.samples["x"].shape == (4, 20, 3)
    assert torch.equal(thinned.samples["x"], dense.samples["x"][:, 2::3])
    assert torch.equal(thinned.info.energy, dense.info.energy[:, 2::3])
    block_any = dense.info.is_divergent.reshape(4, 20, 3).any(-1)
    assert dense.divergences > 0
    assert torch.equal(thinned.info.is_divergent, block_any)
    assert torch.equal(thinned.info.num_integration_steps,
                       dense.info.num_integration_steps.reshape(4, 20, 3).sum(-1).int())


def test_layout_invariance_with_jitter():
    """Chains 0-3 of a 4-chain and a 9-chain run are the same bits,
    jittered starts included; jitter moves every chain's start."""
    # Warmup pools the chains, so the runs compare at a fixed step size.
    kw = dict(num_samples=15, num_warmup=0, seed=11, jitter=0.5, step_size=0.4,
              adapt_step_size=False, **RUN)
    r4 = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_chains=4, **kw)
    r9 = sample(_standard_normal_2d, {"a": 0.0, "b": 0.0}, num_chains=9, **kw)
    for k in ("a", "b"):
        assert torch.equal(r4.samples[k], r9.samples[k][:4])
    assert torch.equal(r4.info.accept_prob, r9.info.accept_prob[:4])
    assert len(torch.unique(r9.samples["a"][:, 0])) == 9
