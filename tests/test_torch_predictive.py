"""The port's posterior predictive (``api.sample_posterior_predictive``)
after ``tests/test_predictive.py``, with predictive functions that take a
``torch.Generator`` (``(generator, params)``, ``(generator, params,
data)``), and its per-chain streams: a chain's draws do not depend on how
many chains the posterior holds."""

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch import Normal, sample, sample_posterior_predictive

CPU = dict(device="cpu")


def test_posterior_predictive_shapes_and_moments():
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.normal(4.0, 1.0, size=100).astype(np.float32))

    def log_prob(params):
        return Normal(0.0, 10.0).log_prob(params["mu"]) + torch.sum(
            Normal(params["mu"], 1.0).log_prob(y))

    res = sample(log_prob, {"mu": 0.0}, num_samples=300, num_warmup=300, num_chains=4,
                 kernel="nuts", seed=0, max_tree_depth=6, **CPU)
    pp = sample_posterior_predictive(lambda g, p: Normal(p["mu"], 1.0).sample(g, (20,)),
                                     res.samples, seed=1, **CPU)
    assert pp.shape == (4, 300, 20)
    draws = pp.numpy().ravel()
    assert abs(draws.mean() - float(y.mean())) < 0.15
    assert abs(draws.std() - 1.0) < 0.1


def test_posterior_predictive_deterministic_and_data_arg():
    samples = {"mu": torch.ones((2, 5))}

    def pred(g, p, data):
        return Normal(p["mu"], data["s"]).sample(g, (3,))

    d = {"s": torch.tensor(0.5)}
    a = sample_posterior_predictive(pred, samples, seed=0, data=d, **CPU)
    b = sample_posterior_predictive(pred, samples, seed=0, data=d, **CPU)
    assert torch.equal(a, b)
    assert a.shape == (2, 5, 3)
    # every draw gets numbers of its own
    assert len(torch.unique(a)) == a.numel()
    c = sample_posterior_predictive(pred, samples, seed=1, data=d, **CPU)
    assert not torch.equal(a, c)


def test_chain_streams_do_not_depend_on_the_chain_count():
    gen = torch.Generator().manual_seed(0)
    four = {"mu": torch.randn(4, 6, generator=gen), "s": torch.rand(4, 6, generator=gen) + 0.5}

    def pred(g, p):
        return {"y": Normal(p["mu"], p["s"]).sample(g, (5,)), "mu": p["mu"]}

    out4 = sample_posterior_predictive(pred, four, seed=3, **CPU)
    out2 = sample_posterior_predictive(pred, {k: v[:2] for k, v in four.items()}, seed=3, **CPU)
    assert out4["y"].shape == (4, 6, 5) and out4["mu"].shape == (4, 6)
    assert torch.equal(out2["y"], out4["y"][:2])


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_posterior_predictive(lambda g, p: p["mu"], {"mu": torch.ones((1, 2))})
