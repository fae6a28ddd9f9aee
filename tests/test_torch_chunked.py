"""Chunked draw storage (``sample(draw_chunk=...)``), warmup segments and
down-cast draw stores, after ``tests/test_chunked.py``.

The engine keys every random input and every schedule flag by the global
step index (``num_warmup + (sample_start + j) * thin`` for stored draw
``j``), so a run cut into chunks or segments must give the uninterrupted
run's bits, not approximately: each chunk continues from the last one's
final positions (their value and gradient evaluated again) and adaptation
state. ``store_dtype='bfloat16'`` rounds only the stored draws.
"""

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch import Normal, sample
from mlx_mcmc_tpu_torch.inference.api import _RUNNER_CACHE
from mlx_mcmc_tpu_torch.inference.engine import build_sampler
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob


def _model(params, data):
    return (
        Normal(0.0, 10.0).log_prob(params["mu"])
        + torch.sum(Normal(0.0, 2.0).log_prob(params["w"]))
        + torch.sum(Normal(params["mu"] + params["w"].sum(), 1.0).log_prob(data["y"]))
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return {"y": torch.from_numpy(rng.normal(1.5, 1.0, 48).astype(np.float32))}


INIT = {"mu": 0.0, "w": torch.zeros(3)}


def _equal_info(a, b):
    assert type(a) is type(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), y.numpy() if torch.is_tensor(y) else y)


@pytest.mark.parametrize("kernel", ["nuts", "hmc", "metropolis", "chees", "mala"])
def test_bit_identical_to_unchunked(kernel, data):
    kw = dict(num_warmup=60, num_chains=4, kernel=kernel, seed=11, data=data, device="cpu")
    if kernel == "nuts":
        kw["max_tree_depth"] = 5
    full = sample(_model, INIT, num_samples=50, **kw)
    chunked = sample(_model, INIT, num_samples=50, draw_chunk=20, **kw)
    for name in full.samples:
        np.testing.assert_array_equal(full.samples[name].numpy(), chunked.samples[name])
    _equal_info(chunked.info, full.info)
    # host-resident store
    assert isinstance(chunked.samples["w"], np.ndarray)
    assert chunked.samples["w"].shape == (4, 50, 3)
    assert chunked.acceptance_rate == pytest.approx(full.acceptance_rate, rel=1e-6)
    assert chunked.divergences == full.divergences
    assert chunked.leapfrog_counts == full.leapfrog_counts
    # ChEES reads its counts once more per continuation chunk
    assert chunked.host_syncs == full.host_syncs + (2 if kernel == "chees" else 0)


def test_remainder_chunk(data):
    kw = dict(num_warmup=40, num_chains=2, kernel="hmc", seed=0, data=data, device="cpu")
    full = sample(_model, INIT, num_samples=31, **kw)
    chunked = sample(_model, INIT, num_samples=31, draw_chunk=10, **kw)
    np.testing.assert_array_equal(full.samples["mu"].numpy(), chunked.samples["mu"])


def test_with_thin(data):
    kw = dict(num_warmup=40, num_chains=2, kernel="hmc", seed=5, data=data, thin=3,
              device="cpu")
    full = sample(_model, INIT, num_samples=20, **kw)
    chunked = sample(_model, INIT, num_samples=20, draw_chunk=8, **kw)
    np.testing.assert_array_equal(full.samples["mu"].numpy(), chunked.samples["mu"])
    # thinned blocks aggregate divergence flags identically
    np.testing.assert_array_equal(full.info.is_divergent.numpy(), chunked.info.is_divergent)


def test_chunk_larger_than_samples_is_unchunked(data):
    kw = dict(num_warmup=30, num_chains=2, kernel="hmc", seed=1, data=data, device="cpu")
    res = sample(_model, INIT, num_samples=10, draw_chunk=64, **kw)
    assert res.samples["mu"].shape == (2, 10) and torch.is_tensor(res.samples["mu"])
    assert torch.equal(res.samples["mu"], sample(_model, INIT, num_samples=10, **kw).samples["mu"])


@pytest.mark.parametrize("chunk", [0, -3])
def test_invalid_chunk_rejected(data, chunk):
    with pytest.raises(ValueError, match="draw_chunk"):
        sample(_model, INIT, num_samples=10, draw_chunk=chunk, num_warmup=10, data=data,
               device="cpu")


def test_chunked_runner_cache_reused(data):
    kw = dict(num_warmup=30, num_chains=2, kernel="hmc", data=data, device="cpu")
    sample(_model, INIT, num_samples=24, draw_chunk=10, seed=2, **kw)
    n = len(_RUNNER_CACHE)
    sample(_model, INIT, num_samples=24, draw_chunk=10, seed=9, **kw)
    assert len(_RUNNER_CACHE) == n  # the second call hit the cached entry
    sample(_model, INIT, num_samples=24, draw_chunk=12, seed=9, **kw)
    assert len(_RUNNER_CACHE) == n  # another chunk size: the draw count is per call


def test_transforms_compose_with_chunks(data):
    def lp(params, data):
        return (
            Normal(0.0, 10.0).log_prob(params["mu"])
            + Normal(0.0, 1.0).log_prob(torch.log(params["sigma"]))
            + torch.sum(Normal(params["mu"], params["sigma"]).log_prob(data["y"]))
        )

    kw = dict(num_warmup=50, num_chains=2, kernel="nuts", seed=4, data=data,
              transforms={"sigma": "log"}, max_tree_depth=5, device="cpu")
    init = {"mu": 0.0, "sigma": 1.0}
    full = sample(lp, init, num_samples=30, **kw)
    chunked = sample(lp, init, num_samples=30, draw_chunk=12, **kw)
    np.testing.assert_array_equal(full.samples["sigma"].numpy(), chunked.samples["sigma"])
    assert np.all(chunked.samples["sigma"] > 0)


def test_bf16_store_rounds_only_storage(data):
    kw = dict(num_warmup=60, num_chains=4, kernel="nuts", seed=7, max_tree_depth=5, data=data,
              device="cpu")
    f32 = sample(_model, INIT, num_samples=50, **kw)
    bf16 = sample(_model, INIT, num_samples=50, store_dtype="bfloat16", **kw)
    a = f32.samples["mu"].numpy()
    b = bf16.samples["mu"].float().numpy()
    assert bf16.samples["mu"].dtype == torch.bfloat16
    # the same chains, the draws only rounded at storage (bf16: 2^-8 relative)
    assert np.max(np.abs(a - b)) <= np.max(np.abs(a)) * 2.0**-7
    # the chains themselves advanced in f32: the diagnostics match exactly
    assert torch.equal(f32.info.num_integration_steps, bf16.info.num_integration_steps)


def test_bf16_store_composes_with_chunks(data):
    kw = dict(num_warmup=40, num_chains=2, kernel="hmc", seed=3, data=data,
              store_dtype="bfloat16", device="cpu")
    full = sample(_model, INIT, num_samples=30, **kw)
    chunked = sample(_model, INIT, num_samples=30, draw_chunk=11, **kw)
    # a chunk comes back widened to float32, exactly
    assert chunked.samples["mu"].dtype == np.float32
    np.testing.assert_array_equal(full.samples["mu"].float().numpy(), chunked.samples["mu"])


@pytest.mark.parametrize("kernel", ["nuts", "chees"])
def test_warmup_segments_resume_bit_for_bit(kernel, data):
    """Warmup [0, a) with no draws, then [a, W) and the draws from the first
    segment's positions and ``(adapt, traj)``, give the uninterrupted run's
    bits; a run that starts past 0 needs a resume state."""
    flp, z, _ = make_flat_logprob(_model, INIT, data_aware=True, device="cpu")
    kw = dict(kernel=kernel, num_warmup=80, max_tree_depth=5, step_size="auto")
    z0 = z.expand(4, z.shape[0]).contiguous()
    full = build_sampler(flp, z.shape[0], num_samples=25, **kw)(3, z0, data)
    first = build_sampler(flp, z.shape[0], num_samples=0, warmup_stop=30, **kw)(3, z0, data)
    assert first.positions.shape == (4, 0, 4)
    rest_run = build_sampler(flp, z.shape[0], num_samples=25, warmup_start=30, **kw)
    rest = rest_run(3, first.final_state.position, data,
                    resume_state=(first.final_adapt, first.final_traj))
    assert torch.equal(full.positions, rest.positions)
    for a, b in zip(full.info, rest.info):
        assert torch.equal(a, b)
    assert torch.equal(full.final_adapt.inv_mass_diag, rest.final_adapt.inv_mass_diag)
    assert full.leapfrog_counts == first.leapfrog_counts + rest.leapfrog_counts
    if kernel == "chees":
        assert len(full.final_traj) == 4
        for a, b in zip(full.final_traj, rest.final_traj):
            assert torch.equal(a, b)
    else:
        assert full.final_traj == ()
    with pytest.raises(ValueError, match="resume_state"):
        rest_run(3, z0, data)
    with pytest.raises(ValueError, match="warmup segment"):
        build_sampler(flp, z.shape[0], warmup_start=50, warmup_stop=40, **kw)


def test_sample_start_offsets_the_draws(data):
    """Draws [10, 25) of a run, from its state after draw 9, are the
    run's draws 10-24 (the continuation evaluates the start again)."""
    flp, z, _ = make_flat_logprob(_model, INIT, data_aware=True, device="cpu")
    kw = dict(kernel="mala", num_warmup=40, step_size="auto")
    z0 = z.expand(3, z.shape[0]).contiguous()
    full = build_sampler(flp, z.shape[0], num_samples=25, **kw)(8, z0, data)
    head = build_sampler(flp, z.shape[0], num_samples=10, **kw)(8, z0, data)
    tail = build_sampler(flp, z.shape[0], num_samples=15, warmup_start=40, **kw)(
        8, head.final_state.position, data, resume_state=(head.final_adapt, ()),
        sample_start=10)
    assert torch.equal(full.positions[:, 10:], tail.positions)
    assert torch.equal(full.info.accept_prob[:, 10:], tail.info.accept_prob)


def test_one_runner_runs_every_chunk(data):
    """A call may run another draw count and warmup segment than the
    build's, so one runner (and on the card one set of graphs) serves the
    first run and every continuation; only the first run probes."""
    flp, z, _ = make_flat_logprob(_model, INIT, data_aware=True, device="cpu")
    kw = dict(kernel="mala", num_warmup=40, step_size="auto")
    z0 = z.expand(3, z.shape[0]).contiguous()
    full = build_sampler(flp, z.shape[0], num_samples=25, **kw)(8, z0, data)
    run = build_sampler(flp, z.shape[0], num_samples=10, **kw)
    head = run(8, z0, data)
    tail = run(8, head.final_state.position, data, resume_state=(head.final_adapt, ()),
               sample_start=10, num_samples=15, warmup_start=40, warmup_stop=40)
    assert torch.equal(full.positions[:, :10], head.positions)
    assert torch.equal(full.positions[:, 10:], tail.positions)
    assert head.probe_evals == head.host_syncs >= 1
    assert full.probe_evals == head.probe_evals
    assert tail.probe_evals == tail.host_syncs == 0
    with pytest.raises(ValueError, match="warmup segment"):
        run(8, z0, data, warmup_start=41, warmup_stop=41)
