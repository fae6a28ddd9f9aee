"""Port parity: ``sample()``'s ``step_size``, ``adapt_step_size`` and
``adapt_mass_matrix`` (reference ``mlx_mcmc_tpu/inference/api.py``).

With the step size fixed, a run is a chain of transitions whose inputs are
the random draws alone, so the port's run can be held to the reference's
step for step: the port's per-step draws are replaced by the reference's
own (``fold_in(fold_in(split(PRNGKey(seed))[1], chain), t)``, split into
the momentum's normals and the uniform table, as ``kernels/nuts.py``
draws them), and every draw, tree depth and the final metric must agree
(tree depths exactly, positions to 1e-5: float32 arithmetic in another
order). The defaults must keep the probe and both adaptations, and the
default run's bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu import sample as j_sample
from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.inference import engine
from mlx_mcmc_tpu_torch.kernels.integrators import sample_momentum

RHO = 0.9
PREC = np.linalg.inv(np.array([[1.0, RHO], [RHO, 1.0]])).astype(np.float32)


def _j_model(p):
    z = p["z"]
    return -0.5 * z @ jnp.asarray(PREC) @ z


def _t_model(p):
    z = p["z"]
    return -0.5 * z @ torch.from_numpy(PREC) @ z


def _reference_draws(seed):
    """The port's ``step_inputs`` with the reference's per-chain draws."""
    key_run = jax.random.split(jax.random.PRNGKey(seed))[1]

    def step_inputs(seed_, chains, t, inv_mass_diag, n_slots):
        dim = inv_mass_diag.shape[0]

        def per_chain(c):
            key = jax.random.fold_in(jax.random.fold_in(key_run, c), t)
            key_momentum, key_loop = jax.random.split(key)
            return (jax.random.normal(key_momentum, (dim,), jnp.float32),
                    jax.random.uniform(key_loop, (n_slots, 4)))

        normals, U = jax.vmap(per_chain)(jnp.asarray(chains.numpy(), jnp.int32))
        normals = torch.from_numpy(np.array(normals))
        return sample_momentum(normals, inv_mass_diag), torch.from_numpy(np.array(U))

    return step_inputs


@pytest.mark.parametrize("adapt_mass_matrix", [False, True])
def test_fixed_step_size_run_matches_reference_step_for_step(monkeypatch, adapt_mass_matrix):
    run = dict(num_chains=4, num_warmup=30, num_samples=8, max_tree_depth=8, seed=5,
               step_size=0.22, adapt_step_size=False, adapt_mass_matrix=adapt_mass_matrix)
    jres = j_sample(_j_model, {"z": jnp.zeros(2)}, kernel="nuts", **run)
    monkeypatch.setattr(engine, "step_inputs", _reference_draws(run["seed"]))
    tres = sample(_t_model, {"z": torch.zeros(2)}, device="cpu", **run)

    assert float(tres.tunables.step_size) == float(jres.tunables.step_size) == np.float32(0.22)
    assert torch.all(tres.info.step_size == np.float32(0.22))
    np.testing.assert_allclose(tres.tunables.inv_mass_diag.numpy(),
                               np.asarray(jres.tunables.inv_mass_diag), rtol=1e-5)
    if not adapt_mass_matrix:
        assert torch.all(tres.tunables.inv_mass_diag == 1.0)
    np.testing.assert_array_equal(tres.info.tree_depth.numpy(), np.asarray(jres.info.tree_depth))
    np.testing.assert_allclose(tres.samples["z"].numpy(), np.asarray(jres.samples["z"]),
                               rtol=1e-5, atol=1e-5)


def test_auto_step_size_rules():
    with pytest.raises(ValueError, match="float or 'auto'"):
        sample(_t_model, {"z": torch.zeros(2)}, num_warmup=2, num_samples=2, step_size="big",
               device="cpu")
    # 'auto' without adaptation pins 0.1, as the reference's resolve_step_size
    res = sample(_t_model, {"z": torch.zeros(2)}, num_warmup=5, num_samples=3, num_chains=2,
                 adapt_step_size=False, device="cpu")
    assert float(res.tunables.step_size) == np.float32(0.1)


def test_defaults_keep_the_default_bits():
    run = dict(num_chains=8, num_warmup=60, num_samples=20, max_tree_depth=6, seed=3,
               device="cpu")
    a = sample(_t_model, {"z": torch.zeros(2)}, **run)
    b = sample(_t_model, {"z": torch.zeros(2)}, step_size="auto", adapt_step_size=True,
               adapt_mass_matrix=True, **run)
    assert torch.equal(a.samples["z"], b.samples["z"])
    assert torch.equal(a.tunables.step_size, b.tunables.step_size)
    assert a.host_syncs == b.host_syncs
    # the probe and both adaptations ran: the step size and metric moved
    assert float(a.tunables.step_size) not in (0.5, 1.0)
    assert not torch.all(a.tunables.inv_mass_diag == 1.0)
    # a float start other than the probe's (0.5 here) adapts from there:
    # other bits
    c = sample(_t_model, {"z": torch.zeros(2)}, step_size=0.3, **run)
    assert not torch.equal(a.samples["z"], c.samples["z"])
    assert float(c.tunables.step_size) not in (0.3, float(a.tunables.step_size))
