"""Port parity: the Normal prior against JAX (tolerance 1e-6 relative)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.distributions import Normal as JNormal
from mlx_mcmc_tpu_torch.distributions import Normal


@pytest.mark.parametrize(
    "loc,scale",
    [(0.0, 1.0), (1.5, 10.0), (np.array([0.0, 1.0, -2.0]), 2.0),
     (0.5, np.array([0.5, 1.0, 3.0]))],
)
def test_normal_log_prob_matches_jax(loc, scale):
    x = np.random.default_rng(0).standard_normal(3).astype(np.float32) * 3
    t_loc = torch.as_tensor(loc, dtype=torch.float32) if isinstance(loc, np.ndarray) else loc
    t_scale = torch.as_tensor(scale, dtype=torch.float32) if isinstance(scale, np.ndarray) else scale
    out_t = Normal(t_loc, t_scale).log_prob(torch.from_numpy(x))
    out_j = JNormal(jnp.asarray(loc, jnp.float32), jnp.asarray(scale, jnp.float32)).log_prob(x)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-6, atol=1e-6)


def test_normal_python_float_scale_edges():
    x = torch.tensor([0.3])
    assert torch.isnan(Normal(0.0, -1.0).log_prob(x)).all()
    assert np.isnan(float(JNormal(0.0, -1.0).log_prob(0.3)))
    assert Normal(0.0, 1.0).batch_shape == ()
    assert Normal(torch.zeros(4), 1.0).batch_shape == (4,)


def test_normal_sample_uses_generator():
    gen = torch.Generator().manual_seed(3)
    a = Normal(1.0, 2.0).sample(gen, (20000,))
    gen.manual_seed(3)
    b = Normal(1.0, 2.0).sample(gen, (20000,))
    assert torch.equal(a, b)
    assert abs(a.mean().item() - 1.0) < 0.05
    assert abs(a.std().item() - 2.0) < 0.05
    assert Normal(torch.zeros(3), 1.0).sample(gen, 5).shape == (5, 3)


def test_normal_moments_match_jax():
    loc, scale = np.array([0.0, 2.0], np.float32), np.array([1.0, 3.0], np.float32)
    t = Normal(torch.from_numpy(loc), torch.from_numpy(scale))
    j = JNormal(jnp.asarray(loc), jnp.asarray(scale))
    for name in ("mean", "variance", "mode", "entropy"):
        np.testing.assert_allclose(
            getattr(t, name)().numpy(), np.asarray(getattr(j, name)()), rtol=1e-6
        )
