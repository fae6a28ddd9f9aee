"""Port parity of random-walk Metropolis (``kernels/metropolis.py``) and its
paths through ``sample()``, after ``tests/test_metropolis.py``.

One transition replayed from JAX's random draws: for 64 chains the
reference's per-chain ``step_fn`` runs under ``vmap``; the port's batched
``step_fn`` gets the same proposal noise and accept uniform (drawn exactly
as ``mlx_mcmc_tpu/kernels/metropolis.py:39-48`` draws them). Accept flags
must match exactly; position, log_prob and accept_prob to 1e-6 relative
(one float32 density evaluation per chain).

Then the reference's oracles at small sizes on the CPU: moments, the
acceptance band of the 0.234 target, an invalid start, vector parameters,
the legacy signature, ``thin`` and layout invariance with ``jitter``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from mlx_mcmc_tpu.kernels.base import Tunables as JTunables
from mlx_mcmc_tpu.kernels.metropolis import make_metropolis_kernel as j_make_mh
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch import Normal, metropolis_hastings, sample
from mlx_mcmc_tpu_torch.convert import tunables_from_jax
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.metropolis import MetropolisState, make_metropolis_kernel
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

C = 64
RTOL = 1e-6


def test_one_transition_matches_jax():
    rng = np.random.default_rng(2)
    dim = 4
    scales = np.array([0.5, 1.0, 2.0, 3.0], np.float32)
    init = {"x": np.zeros(dim, np.float32)}
    jflp, _, _ = j_make_flat_logprob(lambda p: jnp.sum(-0.5 * (p["x"] / scales) ** 2), init)
    t_scales = torch.from_numpy(scales)
    tflp, _, _ = make_flat_logprob(lambda p: torch.sum(-0.5 * (p["x"] / t_scales) ** 2), init,
                                   device="cpu")
    z0 = rng.standard_normal((C, dim)).astype(np.float32)
    j_init, j_step = j_make_mh(jflp)
    j_tun = JTunables(step_size=jnp.asarray(0.9, jnp.float32),
                      inv_mass_diag=jnp.asarray((0.5 + rng.random(dim)).astype(np.float32)))
    j_states = jax.vmap(j_init)(jnp.asarray(z0))
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    j_new, j_info = jax.jit(jax.vmap(j_step, in_axes=(0, 0, None)))(keys, j_states, j_tun)

    def draws(key):  # metropolis.py:39-48
        key_prop, key_accept = jax.random.split(key)
        return (jax.random.normal(key_prop, (dim,), jnp.float32),
                jax.random.uniform(key_accept, (), jnp.float32))

    noise, u = jax.vmap(draws)(keys)
    U = torch.zeros((C, 1, 4))
    U[:, 0, 0] = torch.tensor(np.asarray(u))
    value = make_batched_value(tflp)
    t_init, t_step = make_metropolis_kernel(value)
    t_state = t_init(torch.from_numpy(z0))
    np.testing.assert_allclose(t_state.log_prob.numpy(), np.asarray(j_states.log_prob), rtol=RTOL)
    t_new, t_info, syncs = t_step(t_state, tunables_from_jax(j_tun, device="cpu"),
                                  torch.tensor(np.asarray(noise)), U)
    assert syncs == 0
    np.testing.assert_array_equal(t_info.is_accepted.numpy(), np.asarray(j_info.is_accepted))
    assert 0 < int(t_info.is_accepted.sum()) < C
    for t, j in [(t_new.position, j_new.position), (t_new.log_prob, j_new.log_prob),
                 (t_info.accept_prob, j_info.accept_prob), (t_info.energy, j_info.energy)]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=RTOL)
    assert not t_info.is_divergent.any()
    assert (t_info.num_integration_steps == 0).all() and (t_info.tree_depth == 0).all()


def test_invalid_current_log_prob_always_moves():
    _, step = make_metropolis_kernel(lambda Z: -0.5 * (Z * Z).sum(-1))
    state = MetropolisState(torch.zeros(2, 1), torch.tensor([-math.inf, 0.0]))
    U = torch.full((2, 1, 4), 0.999)
    new, info, _ = step(state, Tunables(torch.tensor(1.0), torch.ones(1)),
                        torch.tensor([[3.0], [3.0]]), U)
    assert info.is_accepted.tolist() == [True, False]
    assert info.accept_prob[0] == 1.0


def _gaussian_model(mu0=2.0, sigma0=1.5):
    def log_prob(params):
        return Normal(mu0, sigma0).log_prob(params["x"])

    return log_prob


RUN = dict(kernel="metropolis", device="cpu")


def test_recovers_moments_and_acceptance_band():
    res = sample(_gaussian_model(), {"x": 0.0}, num_samples=1500, num_warmup=300,
                 num_chains=8, seed=0, **RUN)
    xs = res.samples["x"].numpy().ravel()
    assert abs(xs.mean() - 2.0) < 0.15 and abs(xs.std() - 1.5) < 0.2
    # dual averaging toward the reference's 0.234
    assert 0.1 < res.acceptance_rate < 0.45
    assert res.host_syncs == 0 and res.graph_replays == 0  # no probe: no gradient


def test_invalid_start_recovers():
    def log_prob(params):
        x = params["x"]
        return torch.where(x > 0, Normal(1.0, 1.0).log_prob(x), -math.inf)

    res = sample(log_prob, {"x": -5.0}, num_samples=500, num_warmup=200, num_chains=2, seed=0,
                 step_size=1.0, **RUN)
    assert (res.samples["x"][:, -200:] > 0).all()


def test_vector_parameters_and_reproducibility():
    def log_prob(params):
        return torch.sum(Normal(0.0, 1.0).log_prob(params["v"]))

    res = sample(log_prob, {"v": torch.zeros(5)}, num_samples=1000, num_warmup=200,
                 num_chains=4, seed=0, **RUN)
    v = res.samples["v"]
    assert v.shape == (4, 1000, 5)
    assert (v.mean(dim=(0, 1)).abs() < 0.25).all()
    kw = dict(num_samples=50, num_warmup=20, num_chains=2, seed=3, **RUN)
    a = sample(log_prob, {"v": torch.zeros(5)}, **kw)
    b = sample(log_prob, {"v": torch.zeros(5)}, **kw)
    assert torch.equal(a.samples["v"], b.samples["v"])


def test_legacy_signature():
    samples, accept = metropolis_hastings(_gaussian_model(), {"x": 0.0}, num_samples=300,
                                          proposal_scale=1.0, random_seed=0, device="cpu")
    assert set(samples) == {"x"} and samples["x"].shape == (300,)
    assert isinstance(samples["x"], np.ndarray) and 0.0 < accept < 1.0


def test_thin_stores_block_ends():
    kw = dict(num_warmup=50, num_chains=2, seed=0, step_size=0.6, **RUN)
    dense = sample(_gaussian_model(), {"x": 0.0}, num_samples=200, **kw)
    thinned = sample(_gaussian_model(), {"x": 0.0}, num_samples=40, thin=5, **kw)
    assert thinned.samples["x"].shape == (2, 40)
    assert torch.equal(thinned.samples["x"], dense.samples["x"][:, 4::5])
    assert torch.equal(thinned.info.is_accepted, dense.info.is_accepted[:, 4::5])


def test_layout_invariance_with_jitter():
    kw = dict(num_samples=30, num_warmup=0, seed=5, jitter=1.0, step_size=0.8,
              adapt_step_size=False, **RUN)
    r4 = sample(_gaussian_model(), {"x": 0.0}, num_chains=4, **kw)
    r8 = sample(_gaussian_model(), {"x": 0.0}, num_chains=8, **kw)
    assert torch.equal(r4.samples["x"], r8.samples["x"][:4])
    assert torch.equal(r4.info.is_accepted, r8.info.is_accepted[:4])
