"""Port parity: one NUTS transition replayed from JAX's random draws.

For 32 chains, the reference's per-chain ``step_fn`` runs under ``vmap``;
the port's batched ``step_fn`` gets the same momenta and uniform tables
(computed exactly as nuts.py:187-211 does). Tree depth, leapfrog count and
divergence must match exactly; position, log_prob, grad and accept_prob to
1e-5 relative (float32 arithmetic, reduction order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.kernels.base import Tunables as JTunables
from mlx_mcmc_tpu.kernels.nuts import make_nuts_kernel as j_make_nuts_kernel
from mlx_mcmc_tpu.models import eight_schools as j_eight_schools
from mlx_mcmc_tpu.ops.pallas.glm import prepare_fused_logistic_data as j_prepare
from mlx_mcmc_tpu.ops.ravel import make_flat_logprob as j_make_flat_logprob
from mlx_mcmc_tpu_torch.convert import (
    fused_logistic_data_from_jax,
    hmc_state_from_jax,
    tunables_from_jax,
)
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.kernels.integrators import sample_momentum
from mlx_mcmc_tpu_torch.kernels.nuts import _popcount, _slot_tables, make_nuts_kernel
from mlx_mcmc_tpu_torch.models import eight_schools
from mlx_mcmc_tpu_torch.ops.glm import make_fused_logistic_vag
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

C = 32
RTOL = 1e-5


def _glm_problem(rng):
    n, d = 200, 5
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
    jdata = j_prepare(jnp.asarray(X), jnp.asarray(y), tile_n=128)
    tdata = fused_logistic_data_from_jax(
        {k: np.asarray(v) for k, v in jdata.items()}, device="cpu"
    )
    tvag = make_fused_logistic_vag(prior_scale=1.0)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def jvag(z):
        # The Pallas kernel's tanh/log epilogue (glm.py:97-101) in plain jnp,
        # per chain. The reference's non-Pallas path uses log1p(exp(-|s|)),
        # a formula whose last-ulp differences in ll (~1e-5 nats at |ll| ~
        # 100) would swamp a 1e-5 comparison of accept probabilities.
        s = Xj @ z
        h = jnp.tanh(0.5 * s)
        softplus = jnp.maximum(s, 0.0) - jnp.log(0.5 + 0.5 * jnp.abs(h))
        ll = jnp.sum(yj * s - softplus) - 0.5 * d * np.log(2 * np.pi) - 0.5 * jnp.sum(z * z)
        return ll, Xj.T @ (yj - (0.5 + 0.5 * h)) - z

    z0 = (beta + 0.3 * rng.standard_normal((C, d))).astype(np.float32)
    return jvag, None, lambda Z: tvag(Z, tdata), z0, 6


def _schools_problem(rng):
    jspec = j_eight_schools(centered=True)
    tspec = eight_schools(centered=True, device="cpu")
    jflp, _, _ = j_make_flat_logprob(jspec.log_prob, jspec.initial_params)
    tflp, _, _ = make_flat_logprob(tspec.log_prob, tspec.initial_params, device="cpu")
    z0 = (0.5 * rng.standard_normal((C, 10))).astype(np.float32)
    return None, jflp, make_batched_value_and_grad(tflp), z0, 8


@pytest.mark.parametrize("problem", [_glm_problem, _schools_problem], ids=["glm", "schools"])
def test_one_transition_matches_jax(problem):
    rng = np.random.default_rng(7)
    jvag, jflp, tvag, z0, depth = problem(rng)
    dim = z0.shape[1]
    j_init, j_step = j_make_nuts_kernel(jflp, max_tree_depth=depth, value_and_grad_fn=jvag)
    inv_mass = (0.5 + rng.random(dim)).astype(np.float32)
    j_tun = JTunables(step_size=jnp.asarray(0.35, jnp.float32), inv_mass_diag=jnp.asarray(inv_mass))
    j_states = jax.vmap(j_init)(jnp.asarray(z0))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    j_new, j_info = jax.jit(jax.vmap(j_step, in_axes=(0, 0, None)))(keys, j_states, j_tun)

    # The same randomness as nuts.py:187-211, per chain.
    n_slots = 1 << (depth - 1)

    def draws(key):
        key_momentum, key_loop = jax.random.split(key)
        normals = jax.random.normal(key_momentum, (dim,), jnp.float32)
        return normals, jax.random.uniform(key_loop, (n_slots, 4))

    normals, U = jax.vmap(draws)(keys)
    t_tun = tunables_from_jax(j_tun, device="cpu")
    r0 = sample_momentum(torch.tensor(np.asarray(normals)), t_tun.inv_mass_diag)
    t_init, t_step = make_nuts_kernel(tvag, max_tree_depth=depth)
    t_states = hmc_state_from_jax(j_states, device="cpu")
    t_new, t_info, syncs = t_step(t_states, t_tun, r0, torch.tensor(np.asarray(U)))

    np.testing.assert_array_equal(t_info.tree_depth.numpy(), np.asarray(j_info.tree_depth))
    np.testing.assert_array_equal(
        t_info.num_integration_steps.numpy(), np.asarray(j_info.num_integration_steps)
    )
    np.testing.assert_array_equal(t_info.is_divergent.numpy(), np.asarray(j_info.is_divergent))
    for t, j in [
        (t_new.position, j_new.position),
        (t_new.log_prob, j_new.log_prob),
        (t_new.grad, j_new.grad),
        (t_info.accept_prob, j_info.accept_prob),
        (t_info.energy, j_info.energy),
    ]:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=RTOL)
    # A varied tree: several depths across chains, and one sync per pair
    # iteration of the longest trajectory (root + up to two leaves per
    # iteration) plus the final check.
    assert len(np.unique(t_info.tree_depth.numpy())) > 1
    longest = int(t_info.num_integration_steps.max())
    assert syncs == -(-(longest - 1) // 2) + 1


def test_slot_tables_follow_popcount():
    write, check = _slot_tables(6, "cpu")
    for m in range(0, 32, 2):
        assert write[m].nonzero().flatten().tolist() == [_popcount(m)]
    # Odd leaf 7 closes subtrees of sizes 2, 4, 8: slots popcount(3)-2 .. 2.
    assert check[7].nonzero().flatten().tolist() == [0, 1, 2]
    assert check[5].nonzero().flatten().tolist() == [1]
    assert check[1].nonzero().flatten().tolist() == [0]


@pytest.mark.parametrize("centered", [True, False])
def test_eight_schools_log_prob_matches_jax(centered):
    jspec = j_eight_schools(centered=centered)
    tspec = eight_schools(centered=centered, device="cpu")
    jflp, _, _ = j_make_flat_logprob(jspec.log_prob, jspec.initial_params)
    tflp, _, _ = make_flat_logprob(tspec.log_prob, tspec.initial_params, device="cpu")
    z = np.random.default_rng(1).standard_normal((6, 10)).astype(np.float32)
    j_vals = np.asarray(jax.vmap(jflp)(jnp.asarray(z)))
    t_vals, _ = make_batched_value_and_grad(tflp)(torch.from_numpy(z))
    np.testing.assert_allclose(t_vals.numpy(), j_vals, rtol=1e-6)
