"""Port parity of the unconstraining transforms against JAX.

Each transform's forward, inverse and log-|Jacobian| against
``mlx_mcmc_tpu/distributions/transforms.py`` on the same inputs (float32
tolerance: 1e-5 relative + 1e-5 absolute); the log-|Jacobian| against
autograd; ``make_transformed_logprob`` against the reference's on a
two-parameter model; batched (chains, draws) leading axes; and a
transformed HMC run whose draws stay in the support.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlx_mcmc_tpu.distributions.transforms as jt
from mlx_mcmc_tpu.distributions import Beta as JBeta
from mlx_mcmc_tpu.distributions import Gamma as JGamma
from mlx_mcmc_tpu_torch import Beta, Gamma, HalfNormal, sample
from mlx_mcmc_tpu_torch.distributions import transforms as tt

RTOL = ATOL = 1e-5
NAMES = ["Identity", "Exp", "Softplus", "Sigmoid"]


def _x(shape=(7,), seed=0):
    return np.random.default_rng(seed).uniform(-3, 3, shape).astype(np.float32)


@pytest.mark.parametrize("name", NAMES + ["StickBreaking"])
def test_forward_inverse_log_det_match_jax(name):
    t, j = getattr(tt, name)(), getattr(jt, name)()
    x = _x()
    y_t = t.forward(torch.from_numpy(x))
    y_j = j.forward(jnp.asarray(x))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t.inverse(y_t).numpy(), np.asarray(j.inverse(y_j)), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.inverse(y_t).numpy(), x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(t.log_det_jacobian(torch.from_numpy(x))),
                               float(j.log_det_jacobian(jnp.asarray(x))), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["Exp", "Softplus", "Sigmoid"])
def test_log_det_matches_autograd(name):
    t = getattr(tt, name)()
    for x0 in (-1.5, 0.0, 2.0):
        x = torch.tensor(x0, requires_grad=True)
        (dy,) = torch.autograd.grad(t.forward(x), x)
        assert np.isclose(float(t.log_det_jacobian(x.detach())), float(torch.log(dy.abs())),
                          atol=1e-5)


def test_stick_breaking_simplex_and_jacobian():
    t = tt.StickBreaking()
    x = torch.tensor([0.2, -0.4, 1.3])
    y = t.forward(x)
    assert y.shape == (4,) and (y > 0).all() and abs(float(y.sum()) - 1.0) < 1e-6
    J = torch.autograd.functional.jacobian(lambda v: t.forward(v)[:-1], x)
    assert np.isclose(float(t.log_det_jacobian(x)), float(torch.linalg.slogdet(J)[1]),
                      atol=1e-5)
    # leading (chains, draws) axes pass through
    xb = torch.from_numpy(_x((2, 5, 3)))
    assert torch.allclose(t.forward(xb)[1, 2], t.forward(xb[1, 2]))


def test_get_transform_names():
    assert isinstance(tt.get_transform("log"), tt.Exp)
    assert isinstance(tt.get_transform("logit"), tt.Sigmoid)
    assert isinstance(tt.get_transform("simplex"), tt.StickBreaking)
    inst = tt.Softplus()
    assert tt.get_transform(inst) is inst
    with pytest.raises(KeyError):
        tt.get_transform("nope")


def test_make_transformed_logprob_matches_jax():
    def t_model(p):
        return Gamma(2.0, 1.5).log_prob(p["y"]) + Beta(2.0, 3.0).log_prob(p["q"]) - p["z"] ** 2

    def j_model(p):
        return JGamma(2.0, 1.5).log_prob(p["y"]) + JBeta(2.0, 3.0).log_prob(p["q"]) - p["z"] ** 2

    tfs = {"y": "log", "q": "logit"}
    t_lp, t_to_c, t_to_u = tt.make_transformed_logprob(t_model, tfs)
    j_lp, j_to_c, j_to_u = jt.make_transformed_logprob(j_model, tfs)
    for u in ({"y": 0.3, "q": -1.2, "z": 0.5}, {"y": -2.0, "q": 2.5, "z": -1.0}):
        got = float(t_lp({k: torch.tensor(v) for k, v in u.items()}))
        want = float(j_lp({k: jnp.asarray(v) for k, v in u.items()}))
        assert np.isclose(got, want, rtol=RTOL, atol=ATOL)
    c = {"y": 1.7, "q": 0.25, "z": 3.0}
    back = t_to_u(c)
    j_back = j_to_u(c)
    for k in c:
        assert np.isclose(float(back[k]), float(j_back[k]), rtol=RTOL, atol=ATOL)
        assert np.isclose(float(t_to_c(back)[k]), c[k], rtol=1e-5)
    # the data-aware form: the density of y = exp(x) times exp(x)
    d_lp, _, _ = tt.make_transformed_logprob(lambda p, d: Gamma(2.0, d).log_prob(p["y"]),
                                             {"y": "log"}, data_aware=True)
    want = Gamma(2.0, 1.5).log_prob(torch.exp(torch.tensor(0.3))) + 0.3
    assert np.isclose(float(d_lp({"y": torch.tensor(0.3)}, 1.5)), float(want), atol=1e-6)

def test_transformed_hmc_stays_positive():
    res = sample(lambda p: HalfNormal(2.0).log_prob(p["sigma"]), {"sigma": 1.0},
                 num_samples=300, num_warmup=150, num_chains=4, kernel="hmc", seed=0,
                 transforms={"sigma": "log"}, num_leapfrog_steps=5, device="cpu")
    s = res.samples["sigma"]
    assert s.shape == (4, 300) and (s > 0).all()
    assert abs(float(s.mean()) - 2.0 * np.sqrt(2 / np.pi)) < 0.25


def test_simplex_transform_samples_a_dirichlet():
    """Three simplex weights sampled as two unconstrained values (the
    sampled space has another shape than the parameter): a Dirichlet(2, 3,
    5) density gives means 0.2, 0.3, 0.5."""
    alpha = torch.tensor([2.0, 3.0, 5.0])
    res = sample(lambda p: torch.sum((alpha - 1.0) * torch.log(p["w"])),
                 {"w": torch.tensor([1 / 3, 1 / 3, 1 / 3])}, num_samples=300, num_warmup=150,
                 num_chains=4, kernel="hmc", seed=1, transforms={"w": "simplex"},
                 num_leapfrog_steps=5, device="cpu")
    w = res.samples["w"]
    assert w.shape == (4, 300, 3) and (w > 0).all()
    torch.testing.assert_close(w.sum(-1), torch.ones(4, 300), rtol=0, atol=1e-5)
    assert torch.allclose(w.mean(dim=(0, 1)), alpha / alpha.sum(), atol=0.03)
