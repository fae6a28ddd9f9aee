"""Port parity of MALA (``kernels/mala.py``) and its paths through
``sample()`` and the facade, after ``tests/test_mala.py``.

One transition replayed from JAX's random draws: for 32 chains the
reference's per-chain ``step_fn`` runs under ``vmap``; the port's batched
``step_fn`` gets the same proposal normals and accept uniform (drawn exactly
as ``mlx_mcmc_tpu/kernels/mala.py:50-79`` draws them). Accept and divergence
flags must match exactly; position, log_prob, grad, accept_prob and energy
to 1e-5 relative (float32 arithmetic, reduction order differs).

Then the reference's oracles at the reference's sizes on the CPU (all but
the sharded one, ROADMAP A.10): moment recovery, acceptance near the
target, preconditioning, exact invariance at a coarse fixed step, a
constrained parameter, reproducibility, one gradient per draw, the facade;
through a closed-form value+grad where the model is a Gaussian (the same
sampler at a fraction of autograd's cost per step).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.kernels.base import Tunables as JTunables
from mlx_mcmc_tpu.kernels.mala import make_mala_kernel as j_make_mala_kernel
from mlx_mcmc_tpu.models import eight_schools as j_eight_schools
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch import MCMC, HalfNormal, Normal, sample
from mlx_mcmc_tpu_torch.convert import mala_state_from_jax, tunables_from_jax
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.mala import MALAState, make_mala_kernel
from mlx_mcmc_tpu_torch.models import eight_schools
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

C = 32
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
    return jflp, make_batched_value_and_grad(tflp), z0, 1.2


def _schools_problem(rng):
    jspec = j_eight_schools(centered=True)
    tspec = eight_schools(centered=True, device="cpu")
    jflp, _, _ = j_make_flat_logprob(jspec.log_prob, jspec.initial_params)
    tflp, _, _ = make_flat_logprob(tspec.log_prob, tspec.initial_params, device="cpu")
    z0 = (0.5 * rng.standard_normal((C, 10))).astype(np.float32)
    return jflp, make_batched_value_and_grad(tflp), z0, 0.4


@pytest.mark.parametrize("problem", [_gaussian_problem, _schools_problem],
                         ids=["gaussian", "schools"])
def test_one_transition_matches_jax(problem):
    rng = np.random.default_rng(6)
    jflp, tvag, z0, eps = problem(rng)
    dim = z0.shape[1]
    j_init, j_step = j_make_mala_kernel(jflp)
    inv_mass = (0.5 + rng.random(dim)).astype(np.float32)
    j_tun = JTunables(step_size=jnp.asarray(eps, jnp.float32), inv_mass_diag=jnp.asarray(inv_mass))
    j_states = jax.vmap(j_init)(jnp.asarray(z0))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    j_new, j_info = jax.jit(jax.vmap(j_step, in_axes=(0, 0, None)))(keys, j_states, j_tun)

    def draws(key):  # mala.py:51, 60, 78
        key_prop, key_accept = jax.random.split(key)
        return (jax.random.normal(key_prop, (dim,), jnp.float32),
                jax.random.uniform(key_accept, (), jnp.float32))

    noise, u = jax.vmap(draws)(keys)
    U = torch.zeros((C, 1, 4))
    U[:, 0, 0] = torch.tensor(np.asarray(u))
    _, t_step = make_mala_kernel(tvag)
    t_new, t_info, syncs = t_step(mala_state_from_jax(j_states, device="cpu"),
                                  tunables_from_jax(j_tun, device="cpu"),
                                  torch.tensor(np.asarray(noise)), U)

    assert syncs == 0
    np.testing.assert_array_equal(t_info.is_accepted.numpy(), np.asarray(j_info.is_accepted))
    np.testing.assert_array_equal(t_info.is_divergent.numpy(), np.asarray(j_info.is_divergent))
    assert (t_info.num_integration_steps == 1).all() and (t_info.tree_depth == 0).all()
    for t, j in [(t_new.position, j_new.position), (t_new.log_prob, j_new.log_prob),
                 (t_new.grad, j_new.grad), (t_info.accept_prob, j_info.accept_prob),
                 (t_info.energy, j_info.energy)]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=RTOL)
    # both outcomes occur
    assert 0 < int(t_info.is_accepted.sum()) < C


def test_edge_rules():
    """Non-finite gradients drop out of both means, a -inf current state
    always moves, a NaN log ratio always rejects (``mala.py:57-75``)."""
    def vag(Z):
        ll = torch.where(Z[:, 0] > 5.0, torch.nan, -0.5 * (Z * Z).sum(-1))
        g = torch.where(Z[:, :1] < -5.0, torch.inf, -Z)
        return ll, g

    _, step = make_mala_kernel(vag)
    z0 = torch.tensor([[0.0, 0.0], [-6.0, 0.0], [0.0, 0.0], [4.9, 0.0]])
    ll, g = vag(z0)
    ll[2] = -math.inf
    noise = torch.tensor([[0.1, 0.0], [0.0, 0.0], [0.0, 0.0], [2.0, 0.0]])
    U = torch.full((4, 1, 4), 0.999)
    new, info, _ = step(MALAState(z0, ll, g), Tunables(torch.tensor(0.5), torch.ones(2)),
                        noise, U)
    assert torch.isfinite(new.position).all()
    assert bool(info.is_accepted[2])  # from -inf, always
    # chain 1's infinite gradients count as 0 in both means: with no noise
    # the proposal is its start and the log ratio 0
    assert torch.equal(new.position[1], z0[1]) and float(info.accept_prob[1]) == 1.0
    assert not bool(info.is_accepted[3]) and float(info.accept_prob[3]) == 0.0  # NaN: rejected
    assert bool(info.is_divergent[3])
    assert torch.equal(info.energy, -new.log_prob)


def _std_normal(params):
    return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))


def _gaussian_vag(scales):
    """The closed-form value+grad of independent N(0, scales^2), batched."""
    inv_var = 1.0 / torch.as_tensor(scales, dtype=torch.float32) ** 2

    def vag(Z):
        return -0.5 * (Z * Z * inv_var).sum(-1), -Z * inv_var

    return vag


RUN = dict(kernel="mala", device="cpu")


def test_recovers_standard_normal():
    res = sample(None, {"x": torch.zeros(5)}, value_and_grad_fn=_gaussian_vag([1.0] * 5),
                 num_samples=2000, num_warmup=1000, num_chains=8, seed=0, **RUN)
    xs = res.samples["x"].numpy().reshape(-1, 5)
    assert np.all(np.abs(xs.mean(axis=0)) < 0.1)
    assert np.all(np.abs(xs.std(axis=0) - 1.0) < 0.1)
    assert res.diagnostics()["x"]["r_hat"] < 1.05


def test_acceptance_near_target():
    res = sample(None, {"x": torch.zeros(10)}, value_and_grad_fn=_gaussian_vag([1.0] * 10),
                 num_samples=1000, num_warmup=1000, num_chains=8, seed=1, **RUN)
    assert 0.45 < float(res.info.accept_prob.mean()) < 0.85


def test_anisotropic_target_preconditioned():
    res = sample(None, {"z": torch.zeros(2)}, value_and_grad_fn=_gaussian_vag([1.0, 30.0]),
                 num_samples=3000, num_warmup=1500, num_chains=8, seed=2, **RUN)
    zs = res.samples["z"].numpy().reshape(-1, 2)
    assert abs(zs[:, 0].std() - 1.0) < 0.15
    assert abs(zs[:, 1].std() - 30.0) < 4.5


def test_exact_invariance_single_gaussian_moments():
    # The Hastings correction keeps the variance at 1 at a coarse fixed step.
    res = sample(None, {"x": torch.zeros(1)}, value_and_grad_fn=_gaussian_vag([1.0]),
                 num_samples=4000, num_warmup=200, num_chains=8, step_size=1.2,
                 adapt_step_size=False, adapt_mass_matrix=False, seed=3, **RUN)
    assert abs(res.samples["x"].numpy().std() - 1.0) < 0.06


def test_halfnormal_support():
    res = sample(lambda p: torch.sum(HalfNormal(2.0).log_prob(p["s"])), {"s": torch.ones(3)},
                 num_samples=1500, num_warmup=800, num_chains=4, seed=4,
                 transforms={"s": "log"}, **RUN)
    ss = res.samples["s"].numpy()
    assert (ss > 0).all()
    assert abs(ss.mean() - 2 * math.sqrt(2 / math.pi)) < 0.12


def test_fixed_seed_reproducible_and_one_gradient_per_draw():
    kw = dict(num_samples=200, num_warmup=100, num_chains=4, seed=7, **RUN)
    a = sample(_std_normal, {"x": torch.zeros(2)}, **kw)
    b = sample(_std_normal, {"x": torch.zeros(2)}, **kw)
    assert torch.equal(a.samples["x"], b.samples["x"])
    assert (a.info.num_integration_steps == 1).all()
    assert a.host_syncs > 0  # the probe's reads; a MALA step reads nothing


def test_facade_method():
    mcmc = MCMC(_std_normal)
    samples = mcmc.run({"x": 0.0}, num_samples=500, num_warmup=500, num_chains=4,
                       method="mala", verbose=False, device="cpu")
    assert abs(samples["x"].mean()) < 0.2
    assert 0.0 < mcmc.acceptance_rate <= 1.0
