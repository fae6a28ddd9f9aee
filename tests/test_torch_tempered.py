"""Port parity of parallel tempering (``inference/tempered.py``) against
``mlx_mcmc_tpu/inference/tempered.py``, and the reference's oracles
(``tests/test_tempered.py``) at small sizes on the CPU.

Deterministic pieces: the geometric ladder; the DEO swap sources from the
reference's own uniforms (``tempered.py:86-89``, ``fold_in(key, pair_lo)``)
for both parities; one NUTS and one HMC transition of the port's row block
(3 rungs x 32 chains, per-row step sizes and masses) against the
reference's per-rung kernel on ``beta * log p`` from the same momenta and
uniforms, to ``tests/test_torch_nuts.py``'s tolerances (its problems: the
GLM through K1's plain version and centered eight schools); a swapped
state against a fresh evaluation at its new rung; per-row tunables against
the shared ones, bit for bit, for every kernel.

The reference's draw counts run under ``slow``; tier-1 keeps cases with
the same chains and ladders at fewer draws, within the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.inference.tempered import _swap_sources as j_swap_sources
from mlx_mcmc_tpu.inference.tempered import geometric_ladder as j_geometric_ladder
from mlx_mcmc_tpu.kernels.base import Tunables as JTunables
from mlx_mcmc_tpu.kernels.hmc import make_hmc_kernel as j_make_hmc_kernel
from mlx_mcmc_tpu.kernels.nuts import make_nuts_kernel as j_make_nuts_kernel
from mlx_mcmc_tpu_torch import HalfNormal, Normal, sample, sample_tempered
from mlx_mcmc_tpu_torch.convert import hmc_state_from_jax
from mlx_mcmc_tpu_torch.inference import tempered
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value, make_kernel
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.integrators import sample_momentum
from mlx_mcmc_tpu_torch.ops.random import step_draws
from test_torch_nuts import RTOL, _glm_problem, _schools_problem

CPU = dict(device="cpu")
BETAS = (1.0, 0.5, 0.2)
EPS = (0.35, 0.5, 0.8)  # each rung's step size, ~0.35 / sqrt(beta)


def _bimodal(params):
    # Equal mixture of N(-4, 1) and N(4, 1) (tests/test_tempered.py:14-22).
    x = params["x"]
    la = Normal(-4.0, 1.0).log_prob(x)
    lb = Normal(4.0, 1.0).log_prob(x)
    return torch.sum(torch.logsumexp(torch.stack([la, lb]), dim=0) - np.log(2.0))


def _hard_bimodal(params):
    # Modes at +-6 with scale 0.5: a ~72-nat barrier.
    x = params["x"]
    la = Normal(-6.0, 0.5).log_prob(x)
    lb = Normal(6.0, 0.5).log_prob(x)
    return torch.sum(torch.logsumexp(torch.stack([la, lb]), dim=0) - np.log(2.0))


def _std_normal(params):
    return torch.sum(Normal(0.0, 1.0).log_prob(params["x"]))


# --- deterministic pieces against the reference --------------------------


def test_geometric_ladder_equals_reference():
    for n, b in ((5, 0.0625), (8, 0.1), (10, 0.005), (1, 0.1)):
        np.testing.assert_array_equal(tempered.geometric_ladder(n, b).numpy(),
                                      np.asarray(j_geometric_ladder(n, b)))
    np.testing.assert_allclose(tempered.geometric_ladder(5, 0.0625).numpy(),
                               [1.0, 0.5, 0.25, 0.125, 0.0625], rtol=1e-6)


@pytest.mark.parametrize("parity", [0, 1])
def test_swap_sources_match_reference(parity):
    num, chains = 6, 64
    rng = np.random.default_rng(parity)
    betas = j_geometric_ladder(num, 0.1)
    lp = (-rng.gamma(2.0, 2.0, (chains, num))).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    src_j, alpha_j = jax.vmap(lambda k, l: j_swap_sources(k, betas, l, jnp.asarray(parity)))(
        keys, jnp.asarray(lp))
    # the reference's uniforms, keyed by each pair's lower rung (tempered.py:86-89)
    u = jax.vmap(lambda k: jax.vmap(
        lambda i: jax.random.uniform(jax.random.fold_in(k, i)))(jnp.arange(num)))(keys)
    src, alpha = tempered._swap_sources(torch.from_numpy(np.array(betas)),
                                        torch.from_numpy(lp.T.copy()), parity,
                                        torch.from_numpy(np.asarray(u).T.copy()))
    np.testing.assert_array_equal(src.numpy().T, np.asarray(src_j))
    np.testing.assert_allclose(alpha.numpy().T, np.asarray(alpha_j), rtol=1e-6)
    src = src.numpy()
    # an involution per chain, and some pairs swap, some do not
    np.testing.assert_array_equal(np.take_along_axis(src, src, 0),
                                  np.broadcast_to(np.arange(num)[:, None], src.shape))
    assert 0 < (src != np.arange(num)[:, None]).sum() < src.size


def _rung_problem(problem, kernel):
    """The reference's per-rung transition (``tempered.py:209-217``: the
    kernel on ``beta * log p``, a fused value+grad scaled by beta), vmapped
    over rungs and chains (one compile), each rung with its own keys and
    tunables, and the same draws and tunables as the port's rows
    (rung-major)."""
    rng = np.random.default_rng(7)
    jvag, jflp, tvag, z0, depth = problem(rng)
    if jvag is None:
        # the reference's fused-vag path (tempered.py:209-217), which
        # scales value and gradient as the port does
        jvag = jax.value_and_grad(jflp)
    chains, dim = z0.shape
    num = len(BETAS)
    inv_mass = (0.5 + rng.random((num, dim))).astype(np.float32)
    n_slots = 1 << (depth - 1)

    def kernel_fns(beta):
        kw = {"value_and_grad_fn": lambda z: jax.tree_util.tree_map(lambda t: beta * t, jvag(z))}
        jlp = None if jflp is None else (lambda z: beta * jflp(z))
        if kernel == "nuts":
            return j_make_nuts_kernel(jlp, max_tree_depth=depth, **kw)
        return j_make_hmc_kernel(jlp, num_leapfrog_steps=8, **kw)

    def rung(beta, keys, eps, inv):
        init, step = kernel_fns(beta)
        states = jax.vmap(init)(jnp.asarray(z0))
        tun = JTunables(step_size=eps, inv_mass_diag=inv)
        new, info = jax.vmap(step, in_axes=(0, 0, None))(keys, states, tun)
        return states, new, info

    def draws(key):  # nuts.py:187-211, hmc.py:51-52, 70
        k0, k1 = jax.random.split(key)
        normals = jax.random.normal(k0, (dim,), jnp.float32)
        if kernel == "nuts":
            return normals, jax.random.uniform(k1, (n_slots, 4))
        return normals, jnp.zeros((1, 4)).at[0, 0].set(jax.random.uniform(k1, ()))

    keys = jnp.stack([jax.random.split(jax.random.PRNGKey(11 + r), chains) for r in range(num)])
    states, new, info = jax.jit(jax.vmap(rung))(
        jnp.asarray(BETAS, jnp.float32), keys, jnp.asarray(EPS, jnp.float32),
        jnp.asarray(inv_mass))
    normals, U = jax.vmap(jax.vmap(draws))(keys)
    flat = lambda tree: jax.tree_util.tree_map(  # noqa: E731
        lambda x: np.asarray(x).reshape((num * chains,) + x.shape[2:]), tree)
    ref = dict(states=flat(states), new=flat(new), info=flat(info), normals=flat(normals),
               U=flat(U), eps=np.repeat(np.float32(EPS), chains),
               inv=np.repeat(inv_mass, chains, axis=0))
    return ref, tvag, chains, depth


@pytest.mark.parametrize("kernel", ["nuts", "hmc"])
@pytest.mark.parametrize("problem", [_glm_problem, _schools_problem], ids=["glm", "schools"])
def test_tempered_transition_matches_reference_per_rung(kernel, problem):
    ref, tvag, chains, depth = _rung_problem(problem, kernel)
    state = hmc_state_from_jax(ref["states"], device="cpu")
    tun = Tunables(torch.from_numpy(ref["eps"]), torch.from_numpy(ref["inv"]))
    beta_rows = torch.tensor(BETAS, dtype=torch.float32).repeat_interleave(chains)
    batched = tempered.tempered_density(tvag, beta_rows, True)
    _, step = make_kernel(kernel, batched, num_leapfrog_steps=8, max_tree_depth=depth)
    r0 = sample_momentum(torch.from_numpy(ref["normals"].copy()), tun.inv_mass_diag)
    new, info, _ = step(state, tun, r0, torch.from_numpy(ref["U"].copy()))
    j_new, j_info = ref["new"], ref["info"]
    for field in ("num_integration_steps", "tree_depth", "is_divergent", "is_accepted"):
        np.testing.assert_array_equal(getattr(info, field).numpy(), getattr(j_info, field),
                                      err_msg=field)
    for t, j in [(new.position, j_new.position), (new.log_prob, j_new.log_prob),
                 (info.energy, j_info.energy), (info.step_size, j_info.step_size)]:
        np.testing.assert_allclose(t.numpy(), j, rtol=RTOL, atol=RTOL)
    # accept_prob is exp of an energy difference: its relative error is the
    # difference's absolute one, which scales with |energy| (~100 nats for
    # the GLM, where one float32 ulp is 7.6e-6)
    gap = np.abs(info.accept_prob.numpy() - j_info.accept_prob)
    assert (gap <= RTOL * (1.0 + np.abs(j_info.energy))).all(), gap.max()
    # The gradient at the end of eight schools' hottest rung, up to 95
    # leapfrogs long (the cold rung's longest is 23), carries the two
    # autograds' float32 rounding further: 1.01x RTOL at most, held to 2x.
    np.testing.assert_allclose(new.grad.numpy(), j_new.grad, rtol=2 * RTOL, atol=2 * RTOL)
    if kernel == "nuts":  # hot rungs grow other trees than the cold one
        assert len(np.unique(info.tree_depth.numpy())) > 1


def test_swap_rescales_to_a_fresh_evaluation():
    rng = np.random.default_rng(7)
    _, _, tvag, z0, _ = _glm_problem(rng)
    chains = z0.shape[0]
    betas = torch.tensor([1.0, 0.9, 0.8, 0.7], dtype=torch.float32)
    beta_rows = betas.repeat_interleave(chains)
    density = tempered.tempered_density(tvag, beta_rows, True)
    init, _ = make_kernel("hmc", density)
    Z = torch.from_numpy(z0).repeat(4, 1) + 0.3 * torch.randn(4 * chains, z0.shape[1],
                                                              generator=torch.Generator()
                                                              .manual_seed(0))
    state = init(Z)
    for parity in (0, 1):
        u = torch.rand(4, chains, generator=torch.Generator().manual_seed(parity))
        new, alpha = tempered.swap_round(state, betas, parity, u)
        assert not torch.equal(new.position, state.position)  # some rows swapped
        fresh_lp, fresh_grad = density(new.position)
        np.testing.assert_allclose(new.log_prob.numpy(), fresh_lp.numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(new.grad.numpy(), fresh_grad.numpy(), rtol=1e-5, atol=1e-5)
        assert alpha.shape == (3, chains) and bool(((alpha >= 0) & (alpha <= 1)).all())
        # Metropolis states carry no gradient
        m_init, _ = make_kernel("metropolis", tempered.tempered_density(
            lambda z: tvag(z)[0], beta_rows, False))
        m_new, _ = tempered.swap_round(m_init(Z), betas, parity, u)
        np.testing.assert_allclose(m_new.log_prob.numpy(), fresh_lp.numpy(), rtol=1e-5,
                                   atol=1e-4)


def _gauss_vag(Z):
    scales = torch.linspace(0.5, 2.0, Z.shape[1])
    return -0.5 * ((Z / scales) ** 2).sum(1), -Z / scales**2


@pytest.mark.parametrize("kernel", ["nuts", "hmc", "mala", "metropolis"])
def test_per_row_tunables_give_the_shared_bits(kernel):
    chains, dim = 12, 5
    gen = torch.Generator().manual_seed(1)
    Z = torch.randn(chains, dim, generator=gen)
    inv_mass = 0.5 + torch.rand(dim, generator=gen)
    batched = (lambda z: _gauss_vag(z)[0]) if kernel == "metropolis" else _gauss_vag
    init, step = make_kernel(kernel, batched, max_tree_depth=5, num_leapfrog_steps=5)
    n_slots = 16 if kernel == "nuts" else 1
    x, U = step_draws(3, torch.arange(chains), 7, dim, n_slots)
    if kernel in ("nuts", "hmc"):
        x = sample_momentum(x, inv_mass)

    def run(tun, rows=slice(None)):
        state = init(Z[rows])
        return step(state, tun, x[rows], U[rows])[:2]

    shared = run(Tunables(torch.tensor(0.4), inv_mass))
    per_row = run(Tunables(torch.full((chains,), 0.4), inv_mass.expand(chains, dim).clone()))
    for a, b in zip(list(shared[0]) + list(shared[1]), list(per_row[0]) + list(per_row[1])):
        assert torch.equal(a, b)
    # rows of different step sizes each equal a run at that row's step size
    eps = torch.tensor([0.1, 0.4, 0.9] * 4)
    mixed = run(Tunables(eps, inv_mass.expand(chains, dim).clone()))
    for e in (0.1, 0.4, 0.9):
        rows = torch.nonzero(eps == e).flatten()
        alone = run(Tunables(torch.tensor(e), inv_mass), rows)
        for a, b in zip(list(alone[0]) + list(alone[1]), list(mixed[0]) + list(mixed[1])):
            assert torch.equal(a, b[rows])


# --- the reference's oracles (tests/test_tempered.py) ----------------------


def test_bad_ladders_rejected():
    for bad in ([0.5, 0.25], [1.0, 0.5, 0.7], [1.0, 0.5, -0.1]):
        with pytest.raises(ValueError, match="betas"):
            sample_tempered(_std_normal, {"x": 0.0}, betas=bad, num_samples=10, num_warmup=10,
                            **CPU)
    with pytest.raises(ValueError, match="256"):
        sample_tempered(_std_normal, {"x": 0.0}, num_replicas=257, num_samples=2,
                        num_warmup=2, **CPU)
    with pytest.raises(ValueError, match="2\\*\\*24"):
        sample_tempered(_std_normal, {"x": 0.0}, num_chains=1 << 24, num_samples=2,
                        num_warmup=2, **CPU)


def test_chees_rejected():
    with pytest.raises(ValueError, match="chees"):
        sample_tempered(_std_normal, {"x": 0.0}, kernel="chees", num_samples=10, num_warmup=10,
                        **CPU)


def test_pair_decisions_symmetric():
    betas = tempered.geometric_ladder(6, 0.1)
    lp = torch.tensor([-1.0, -5.0, -2.0, -9.0, -3.0, -0.5])[:, None]
    u = torch.rand(6, 1, generator=torch.Generator().manual_seed(3))
    for parity in (0, 1):
        src, _ = tempered._swap_sources(betas, lp, parity, u)
        src = src[:, 0].numpy()
        np.testing.assert_array_equal(src[src], np.arange(6))


@pytest.mark.parametrize("draws", [
    pytest.param((300, 300), id="tier1"),
    pytest.param((3000, 1000), id="reference", marks=pytest.mark.slow),
])
def test_swaps_preserve_unimodal_posterior(draws):
    num_samples, num_warmup = draws
    res = sample_tempered(_std_normal, {"x": torch.zeros(3)}, num_samples=num_samples,
                          num_warmup=num_warmup, num_chains=4, num_replicas=4, kernel="hmc",
                          seed=0, **CPU)
    xs = res.samples["x"].reshape(-1, 3).numpy()
    assert np.all(np.abs(xs.mean(axis=0)) < 0.1)
    assert np.all(np.abs(xs.std(axis=0) - 1.0) < 0.1)
    assert (res.swap_acceptance > 0.5).all()


@pytest.mark.parametrize("draws", [
    pytest.param((300, 200, 600, 300), id="tier1"),
    pytest.param((1500, 500, 1500, 1000), id="reference", marks=pytest.mark.slow),
])
def test_plain_hmc_stuck_pt_mixes(draws):
    plain_samples, plain_warmup, pt_samples, pt_warmup = draws
    plain = sample(_hard_bimodal, {"x": -6.0 * torch.ones(1)}, num_samples=plain_samples,
                   num_warmup=plain_warmup, num_chains=4, kernel="hmc", seed=1, **CPU)
    assert (plain.samples["x"].numpy().ravel() > 0).mean() < 0.02  # never crosses
    pt = sample_tempered(_hard_bimodal, {"x": -6.0 * torch.ones(1)}, num_samples=pt_samples,
                         num_warmup=pt_warmup, num_chains=4, num_replicas=10, beta_min=0.005,
                         kernel="hmc", seed=1, **CPU)
    xs = pt.samples["x"].numpy().ravel()
    assert 0.3 < (xs > 0).mean() < 0.7  # both modes, near-equal weights
    assert abs(np.abs(xs).mean() - 6.0) < 0.3
    assert pt.divergences == 0


@pytest.mark.parametrize("kernel", ["mala", "nuts"])
def test_mala_and_nuts_kernels(kernel):
    # the reference's 1200 + 800; NUTS cut to 600 + 300 (eager trees)
    pt = sample_tempered(_bimodal, {"x": -4.0 * torch.ones(1)},
                         num_samples=1200 if kernel == "mala" else 600,
                         num_warmup=800 if kernel == "mala" else 300, num_chains=2,
                         num_replicas=8, beta_min=0.02, kernel=kernel, seed=2,
                         **({"max_tree_depth": 6} if kernel == "nuts" else {}), **CPU)
    xs = pt.samples["x"].numpy().ravel()
    assert 0.2 < (xs > 0).mean() < 0.8, kernel


def test_metropolis_kernel_runs():
    pt = sample_tempered(_std_normal, {"x": torch.zeros(2)}, num_samples=300, num_warmup=300,
                         num_chains=2, num_replicas=4, kernel="metropolis", seed=3, **CPU)
    xs = pt.samples["x"].numpy()
    assert np.isfinite(xs).all()
    assert abs(xs.mean()) < 0.3
    assert pt.final_state._fields == ("position", "log_prob")


def test_fixed_seed_reproducible_and_layout_invariant():
    kw = dict(num_samples=60, num_warmup=40, num_replicas=4, kernel="hmc", seed=5,
              adapt_step_size=False, adapt_mass_matrix=False, jitter=0.5, **CPU)
    a = sample_tempered(_bimodal, {"x": torch.zeros(1)}, num_chains=2, **kw)
    b = sample_tempered(_bimodal, {"x": torch.zeros(1)}, num_chains=2, **kw)
    assert torch.equal(a.samples["x"], b.samples["x"])
    # at fixed tunables a chain's draws do not depend on the chain count
    c = sample_tempered(_bimodal, {"x": torch.zeros(1)}, num_chains=5, **kw)
    assert torch.equal(a.samples["x"], c.samples["x"][:2])


def test_result_fields():
    res = sample_tempered(_std_normal, {"x": torch.zeros(2)}, num_samples=100, num_warmup=100,
                          num_chains=2, num_replicas=4, kernel="hmc", seed=6, **CPU)
    assert res.betas.shape == (4,) and res.betas[0] == 1.0
    assert res.swap_acceptance.shape == (3,)
    assert res.replica_step_sizes.shape == (4,)
    assert (res.swap_acceptance >= 0).all() and (res.swap_acceptance <= 1).all()
    assert np.isfinite(res.replica_step_sizes).all()
    assert (res.replica_step_sizes > 0).all()
    assert res.samples["x"].shape == (2, 100, 2)
    assert res.info.accept_prob.shape == (2, 100)
    assert res.diagnostics()["x"]["r_hat"] < 1.1
    assert float(res.tunables.step_size) == pytest.approx(float(res.replica_step_sizes[0]))
    # the cold rung's final state: its log density at its position
    fresh = torch.stack([_std_normal({"x": z}) for z in res.final_state.position])
    np.testing.assert_allclose(res.final_state.log_prob.numpy(), fresh.numpy(), rtol=1e-5)


def test_transforms_path():
    def log_prob(params):
        return torch.sum(HalfNormal(2.0).log_prob(params["s"]))

    res = sample_tempered(log_prob, {"s": torch.ones(2)}, num_samples=400, num_warmup=300,
                          num_chains=2, num_replicas=4, kernel="hmc", seed=7,
                          transforms={"s": "log"}, **CPU)
    ss = res.samples["s"].numpy()
    assert (ss > 0).all()
    assert abs(ss.mean() - 1.5958) < 0.2


def test_fused_value_and_grad_and_runner_cache():
    # A fused value+grad with no model (the smoke's glm100_fused path), and
    # the runner cache: a second call with the same settings reuses the
    # runner (on the card, its graphs).
    from mlx_mcmc_tpu_torch.inference import api

    def vag(Z, data):
        return _gauss_vag(Z - data)

    data = torch.tensor(1.5)
    kw = dict(num_samples=50, num_warmup=30, num_chains=3, num_replicas=3, kernel="nuts",
              max_tree_depth=4, seed=2, data=data, value_and_grad_fn=vag, **CPU)
    api.clear_runner_cache()
    a = sample_tempered(None, {"x": torch.zeros(4)}, **kw)
    assert len(api._RUNNER_CACHE) == 1
    b = sample_tempered(None, {"x": torch.zeros(4)}, **kw)
    assert len(api._RUNNER_CACHE) == 1
    assert torch.equal(a.samples["x"], b.samples["x"])
    assert a.host_syncs > 0 and a.graph_replays == 0


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sample_tempered(_std_normal, {"x": 0.0}, num_samples=2, num_warmup=2)


def test_value_path_matches_metropolis_value():
    # Metropolis under tempering evaluates the model's value, scaled by beta
    flp = lambda z: -0.5 * (z * z).sum()  # noqa: E731
    value = make_batched_value(flp)
    beta_rows = torch.tensor([1.0, 1.0, 0.5, 0.5])
    z = torch.randn(4, 3, generator=torch.Generator().manual_seed(0))
    got = tempered.tempered_density(value, beta_rows, False)(z)
    np.testing.assert_allclose(got.numpy(), (beta_rows * value(z)).numpy())
