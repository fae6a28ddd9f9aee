"""The port's compiled-runner cache (``inference/api.py``), after
``tests/test_runner_cache.py``: repeated ``sample()`` calls with one static
configuration reuse its runner (on the card, with the CUDA graphs of its
transition) and give the same bits as a fresh build.

Unlike the reference, the chain count and the ``data`` tensors (by
identity) are part of the key, because the graphs bake them in. As in the
reference, the key holds the kernel and its kwargs and the transforms
(names by value, ``Transform`` instances by identity). What a run hands
its runner per call is not a key: ``jitter``, the initial values (also
``batched_initial`` ones), the initial metric, the draw count and
``draw_chunk``.
"""

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch import sample
from mlx_mcmc_tpu_torch.distributions import Exp, Normal
from mlx_mcmc_tpu_torch.inference import api


def _model(params):
    return Normal(1.0, 2.0).log_prob(params["x"]).sum()


def _data_model(params, data):
    return Normal(data["mu"], 2.0).log_prob(params["x"]).sum()


def _run(seed=0, model=_model, init=None, **kw):
    defaults = dict(num_samples=30, num_warmup=30, num_chains=4, seed=seed, device="cpu",
                    max_tree_depth=5)
    defaults.update(kw)
    return sample(model, {"x": torch.zeros(3)} if init is None else init, **defaults)


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.clear_runner_cache()
    yield
    api.clear_runner_cache()


def test_cache_hit_same_config():
    _run(seed=0)
    assert len(api._RUNNER_CACHE) == 1
    _run(seed=1)  # the seed is a runtime argument: no new entry
    assert len(api._RUNNER_CACHE) == 1


def test_cached_run_bitwise_equals_fresh_build():
    r1 = _run(seed=3)
    r2 = _run(seed=3)  # cache hit
    api.clear_runner_cache()
    r3 = _run(seed=3)  # fresh build
    for r in (r2, r3):
        assert torch.equal(r1.samples["x"], r.samples["x"])
        for a, b in zip(r1.info, r.info):
            assert torch.equal(a, b)
        assert r.host_syncs == r1.host_syncs


def test_different_settings_get_distinct_entries():
    _run()
    _run(max_tree_depth=4)
    _run(num_warmup=40)
    _run(static_schedule=True)
    _run(target_accept=0.9)
    _run(store_dtype="bfloat16")
    assert len(api._RUNNER_CACHE) == 6


def test_tunable_settings_get_distinct_entries():
    # the reference's key holds step_size, adapt_step_size and
    # adapt_mass_matrix (api.py:347-366); "auto" resolves before the key
    _run()
    _run(step_size="auto")
    assert len(api._RUNNER_CACHE) == 1
    _run(step_size=0.3)
    _run(step_size=0.3, adapt_step_size=False)
    _run(adapt_mass_matrix=False)
    _run(adapt_step_size=False)  # 'auto' pins 0.1
    _run(step_size=0.1, adapt_step_size=False)  # the same runner as the last
    assert len(api._RUNNER_CACHE) == 5


def test_value_changes_do_not_invalidate():
    r_zero = _run(init={"x": torch.zeros(3)})
    r_ones = _run(init={"x": torch.ones(3)})
    assert len(api._RUNNER_CACHE) == 1  # same structure: reused
    # the new starting values must flow through
    assert not torch.equal(r_zero.samples["x"][:, 0], r_ones.samples["x"][:, 0])


def test_new_chain_count_gets_new_entry():
    r4 = _run(seed=5)
    r8 = _run(seed=5, num_chains=8)  # the graphs bake in the chain count
    assert len(api._RUNNER_CACHE) == 2
    assert r4.samples["x"].shape[0] == 4 and r8.samples["x"].shape[0] == 8


def test_new_data_gets_new_entry():
    data_a = {"mu": torch.tensor(1.0)}
    data_b = {"mu": torch.tensor(-1.0)}
    ra = _run(model=_data_model, data=data_a)
    _run(model=_data_model, data=data_a)
    assert len(api._RUNNER_CACHE) == 1
    rb = _run(model=_data_model, data=data_b)  # other tensors: other addresses
    assert len(api._RUNNER_CACHE) == 2
    assert float(ra.samples["x"].mean()) > float(rb.samples["x"].mean())


def test_unkeyable_data_bypasses_cache():
    _run(model=_data_model, data={"mu": np.float32(1.0)})
    assert len(api._RUNNER_CACHE) == 0


def test_distinct_model_objects_miss():
    def m1(params):
        return Normal(0.0, 1.0).log_prob(params["x"]).sum()

    def m2(params):
        return Normal(0.0, 1.0).log_prob(params["x"]).sum()

    _run(model=m1)
    _run(model=m2)
    assert len(api._RUNNER_CACHE) == 2


def test_clear_runner_cache_empties_it():
    _run()
    _run(num_chains=2)
    assert len(api._RUNNER_CACHE) == 2
    api.clear_runner_cache()
    assert len(api._RUNNER_CACHE) == 0


def test_eviction_is_least_recently_used(monkeypatch):
    monkeypatch.setattr(api, "_RUNNER_CACHE_MAX", 2)
    _run(num_chains=1)
    _run(num_chains=2)
    _run(num_chains=1)  # hit: now the most recently used
    _run(num_chains=3)  # evicts num_chains=2
    chains = sorted(key[4] for key in api._RUNNER_CACHE)
    assert chains == [1, 3]


def test_kernel_and_its_kwargs_get_distinct_entries():
    _run()
    _run(kernel="hmc")
    _run(kernel="hmc", num_leapfrog_steps=4)
    _run(kernel="metropolis")
    _run(thin=2)
    _run(progress_every=10, progress_callback=lambda *a: None)
    assert len(api._RUNNER_CACHE) == 6
    # the initial metric is a per-call value: the same runner, other draws
    a = _run(kernel="hmc", num_leapfrog_steps=4, init_inv_mass_diag=torch.full((3,), 2.0))
    b = _run(kernel="hmc", num_leapfrog_steps=4)
    assert len(api._RUNNER_CACHE) == 6
    assert not torch.equal(a.samples["x"], b.samples["x"])


def test_transforms_keyed_by_name_and_instance_identity():
    _run(transforms={"x": "log"}, init={"x": torch.ones(3)})
    _run(transforms={"x": "log"}, init={"x": torch.ones(3)})
    assert len(api._RUNNER_CACHE) == 1
    tf = Exp()
    _run(transforms={"x": tf}, init={"x": torch.ones(3)})
    _run(transforms={"x": tf}, init={"x": torch.ones(3)})
    assert len(api._RUNNER_CACHE) == 2
    _run(transforms={"x": Exp()}, init={"x": torch.ones(3)})  # another instance
    assert len(api._RUNNER_CACHE) == 3


def test_batched_initial_is_a_key_and_jitter_is_not():
    r0 = _run(seed=2)
    r1 = _run(seed=2, jitter=0.5)
    assert len(api._RUNNER_CACHE) == 1
    assert not torch.equal(r0.samples["x"], r1.samples["x"])
    # batched starts are per-call values too: one chain's structure is the
    # key's
    start = {"x": torch.arange(12.0).reshape(4, 3)}
    rb = _run(seed=2, init=start, batched_initial=True)
    assert len(api._RUNNER_CACHE) == 1
    rb2 = _run(seed=2, init={"x": -start["x"]}, batched_initial=True)
    assert len(api._RUNNER_CACHE) == 1  # new starting values, the same runner
    assert not torch.equal(rb.samples["x"], rb2.samples["x"])


def test_chees_mala_and_their_kwargs_get_distinct_entries():
    _run(kernel="chees")
    _run(kernel="chees", max_leapfrog_steps=8)
    _run(kernel="mala")
    _run(kernel="mala", draw_chunk=3)  # chunks run on the same runner
    assert len(api._RUNNER_CACHE) == 3
    _run(kernel="chees", max_leapfrog_steps=8)
    _run(kernel="mala", draw_chunk=3, seed=5)
    _run(kernel="mala", init_strategy="map")  # a per-call start, not a key
    assert len(api._RUNNER_CACHE) == 3
