"""``sample()``'s ``config=`` (``utils/config.py``) and ``init_strategy``
(``inference/init_strategies.py``) against the reference package.

- ``SamplerConfig.to_kwargs()`` equals the reference's for every kernel
  and for the storage, thinning and adaptation fields; ``MeshConfig.build``
  lays out the world's ranks (a world of one here, ended after its test),
  raises on a layout that the world cannot fill, and observation sharding
  over an axis it lacks, or without data, raises (the sharded paths
  themselves: ``tests/test_torch_data_sharding.py``).
- ``sample(config=...)`` gives the spelled-out call's bits; an explicit
  ``store_dtype``/``draw_chunk`` wins over the config's.
- ``init_strategy='map'`` lands absurdly far starts near the mode
  (``tests/test_facade.py:193-215``), and its Adam is ``optax.adam``'s: 200
  steps from the same start on a Gaussian agree with optax to 1e-4; an
  unknown strategy raises ``ValueError``, and 'advi' runs (its draws of the
  right shapes, sigma's in its support; ``tests/test_torch_vi.py`` holds
  the fit itself).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mlx_mcmc_tpu.utils import config as j_config
from mlx_mcmc_tpu_torch import HalfNormal, Normal, sample
from mlx_mcmc_tpu_torch.inference.init_strategies import MAP_JITTER_STEP, map_initialize
from mlx_mcmc_tpu_torch.ops.random import step_draws
from mlx_mcmc_tpu_torch.utils import AdaptationConfig, MeshConfig, SamplerConfig

_CONFIGS = [
    dict(kernel="nuts"),
    dict(kernel="hmc", num_leapfrog_steps=5, num_samples=150, num_warmup=100, num_chains=2),
    dict(kernel="metropolis", step_size=0.3, seed=4, jitter=0.5),
    dict(kernel="chees", max_leapfrog_steps=64, thin=3, store_dtype="bfloat16"),
    dict(kernel="mala", draw_chunk=100, adaptation=dict(target_accept=0.6,
                                                        adapt_mass_matrix=False)),
]


@pytest.mark.parametrize("fields", _CONFIGS, ids=[c["kernel"] for c in _CONFIGS])
def test_to_kwargs_matches_the_reference(fields):
    ad = fields.pop("adaptation", None)
    mine = SamplerConfig(**fields, **({} if ad is None else {"adaptation": AdaptationConfig(**ad)}))
    ref = j_config.SamplerConfig(
        **fields, **({} if ad is None else {"adaptation": j_config.AdaptationConfig(**ad)}))
    assert mine.to_kwargs() == ref.to_kwargs()
    assert [f.name for f in dataclasses.fields(SamplerConfig)] == [
        f.name for f in dataclasses.fields(j_config.SamplerConfig)]
    assert dataclasses.asdict(AdaptationConfig()) == dataclasses.asdict(j_config.AdaptationConfig())


def test_mesh_config_raises_naming_its_roadmap_item():
    import torch.distributed as dist

    from mlx_mcmc_tpu_torch.parallel import initialize_distributed, sample_sharded

    assert MeshConfig().axis_names == j_config.MeshConfig().axis_names
    assert not dist.is_initialized()
    initialize_distributed(device="cpu")
    try:
        assert MeshConfig().build().mesh_dim_names == ("chains",)
        mesh = MeshConfig(chains=1, data=1).build()
        assert mesh.mesh_dim_names == ("chains",)
        assert MeshConfig(data=1).build().shape == (1,)
        with pytest.raises(ValueError, match="the world has 1"):
            MeshConfig(chains=4).build()
        with pytest.raises(ValueError, match="requires data"):
            sample_sharded(_model, {"x": torch.zeros(2)}, mesh=mesh, data_axis="data",
                           device="cpu")
        with pytest.raises(ValueError, match="not in mesh axes"):
            sample_sharded(_model, {"x": torch.zeros(2)}, mesh=mesh, data_axis="data",
                           data={"y": torch.zeros(4)}, device="cpu")
    finally:
        dist.destroy_process_group()


def _model(params):
    return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))


@pytest.mark.parametrize("kernel", ["hmc", "chees", "mala"])
def test_config_equals_the_spelled_out_call(kernel):
    cfg = SamplerConfig(kernel=kernel, num_samples=40, num_warmup=60, num_chains=3, seed=5,
                        jitter=0.3, thin=2, num_leapfrog_steps=4, max_leapfrog_steps=16,
                        adaptation=AdaptationConfig(target_accept=0.7))
    a = sample(_model, {"x": torch.zeros(2)}, config=cfg, device="cpu")
    b = sample(_model, {"x": torch.zeros(2)}, kernel=kernel, num_samples=40, num_warmup=60,
               num_chains=3, seed=5, jitter=0.3, thin=2, target_accept=0.7,
               num_leapfrog_steps=4 if kernel == "hmc" else 10,
               max_leapfrog_steps=16 if kernel == "chees" else 1000, device="cpu")
    assert a.kernel == kernel and a.samples["x"].shape == (3, 40, 2)
    assert torch.equal(a.samples["x"], b.samples["x"])
    for x, y in zip(a.info, b.info):
        assert torch.equal(x, y)


def test_explicit_store_dtype_and_draw_chunk_win():
    cfg = SamplerConfig(kernel="hmc", num_samples=30, num_warmup=20, num_chains=2,
                        store_dtype="float32", draw_chunk=7)
    res = sample(_model, {"x": torch.zeros(2)}, config=cfg, store_dtype="bfloat16",
                 draw_chunk=100, device="cpu")
    assert res.samples["x"].dtype == torch.bfloat16  # unchunked, a bf16 store
    chunked = sample(_model, {"x": torch.zeros(2)}, config=cfg, device="cpu")
    assert isinstance(chunked.samples["x"], np.ndarray)
    np.testing.assert_array_equal(chunked.samples["x"], sample(
        _model, {"x": torch.zeros(2)}, config=dataclasses.replace(cfg, draw_chunk=None),
        device="cpu").samples["x"].numpy())


def test_map_adam_is_optax_adam():
    """Without jitter, 200 Adam steps on a Gaussian from the same starts
    agree with optax's to 1e-4 (float32; the bias corrections round
    differently, and 200 steps of Adam, still moving, carry that to ~2e-5)."""
    prec = np.array([[2.0, 0.6, 0.0], [0.6, 1.0, 0.2], [0.0, 0.2, 0.5]], np.float32)
    mean = np.array([1.0, -2.0, 0.5], np.float32)
    z0 = np.random.default_rng(3).normal(size=(5, 3)).astype(np.float32) * 4

    def vag(Z):
        g = (torch.from_numpy(mean) - Z) @ torch.from_numpy(prec)
        return -0.5 * ((Z - torch.from_numpy(mean)) * -g).sum(-1), g

    got = map_initialize(vag, torch.from_numpy(z0), 0, jitter=0.0)
    opt = optax.adam(0.05)

    def one(z):
        state = opt.init(z)

        def body(carry, _):
            z, state = carry
            g = (z - mean) @ prec
            updates, state = opt.update(g, state, z)
            return (optax.apply_updates(z, updates), state), None

        return jax.lax.scan(body, (z, state), None, length=200)[0][0]

    want = np.asarray(jax.vmap(one)(jnp.asarray(z0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_map_jitter_and_fallback():
    """The jitter is chain i's Philox normals at the reserved step; a chain
    that ends non-finite keeps its start."""
    z0 = torch.zeros(4, 2)
    steps0 = map_initialize(lambda Z: (-0.5 * (Z * Z).sum(-1), -Z), z0, 7, num_steps=0,
                            jitter=0.5)
    noise, _ = step_draws(7, torch.arange(4), MAP_JITTER_STEP, 2, 0)
    assert torch.equal(steps0, 0.5 * noise)

    def vag(Z):  # a wall at x0 = 1: -inf beyond, NaN gradients there
        ll = -0.5 * (Z * Z).sum(-1)
        return torch.where(Z[:, 0] > 1, -torch.inf, ll), torch.where(Z[:, :1] > 1, torch.nan, -Z)

    z0 = torch.full((4, 2), 0.8)
    out = map_initialize(vag, z0, 7, jitter=0.5)
    bad = (0.8 + 0.5 * noise[:, 0]) > 1
    assert bad.any() and not bad.all()
    assert torch.equal(out[bad], z0[bad])
    assert (out[~bad].abs() < 0.1).all()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    return torch.from_numpy(rng.normal(5.0, 2.0, 100).astype(np.float32))


def _facade_model(data):
    def log_prob(params):
        mu, sigma = params["mu"], params["sigma"]
        lp = Normal(0.0, 10.0).log_prob(mu) + HalfNormal(5.0).log_prob(sigma)
        return lp + torch.sum(Normal(mu, sigma).log_prob(data))

    return log_prob


def test_map_init_starts_near_mode(data):
    res = sample(_facade_model(data), {"mu": -200.0, "sigma": 50.0}, num_samples=300,
                 num_warmup=300, num_chains=4, kernel="nuts", seed=0, init_strategy="map",
                 device="cpu")
    mu = res.samples["mu"].numpy().ravel()
    assert abs(mu.mean() - float(data.mean())) < 0.3


def test_unknown_and_unported_strategies_raise(data):
    with pytest.raises(ValueError, match="init_strategy"):
        sample(_facade_model(data), {"mu": 0.0, "sigma": 1.0}, num_samples=10, num_warmup=10,
               init_strategy="magic", device="cpu")
    res = sample(_facade_model(data), {"mu": 0.0, "sigma": 1.0}, num_samples=10, num_warmup=10,
                 num_chains=3, init_strategy="advi", transforms={"sigma": "log"}, device="cpu")
    assert res.samples["mu"].shape == (3, 10) and res.samples["sigma"].shape == (3, 10)
    assert bool((res.samples["sigma"] > 0).all()) and bool(torch.isfinite(res.samples["mu"]).all())
