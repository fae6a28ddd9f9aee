"""The transitions that CUDA graphs capture, on the CPU.

``pairs(frame, carry, k)`` runs k masked pair iterations without a host
read; surplus iterations change nothing, so a transition must give the same
bits whatever k is, and the reference's fixed-trip ``static_schedule`` the
same bits as the dynamic loop. Each case runs three transitions at fixed
tunables, from the engine's per-chain random inputs, through an elementwise
model, the plain versions of the K1 (logistic), K2 (linear) and K3
(Poisson) value+grads at small shapes and the generic autograd value+grad
of the eight-schools funnel, and compares every output bit for bit.

``inference/graphs.py`` is checked here with its capture emulated: a
"graph" that replays by running the captured function again and copying
its outputs into the first run's tensors, as a replay writes into the
addresses it captured. That holds ``GraphedTransition`` (static inputs,
carry buffers updated in place, host checks, the result buffers) to the
eager loop bit for bit, ``GraphedStep`` (HMC, Metropolis and MALA, one
graph per transition) and ``GraphedTrajectory`` (ChEES: start, one
leapfrog replayed n times, end) the same way. The replay launch-count arithmetic is
checked with a stub graph.
The ``cuda`` tests hold real graphs against the eager loop on the card and
skip here; this file imports no JAX, so they run where JAX is absent:

    python -m pytest tests/test_torch_capture.py --noconftest -m cuda
"""

import contextlib

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch import _capture
from mlx_mcmc_tpu_torch.inference import graphs
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad, step_inputs
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.chees import make_chees_kernel, make_chees_parts
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState, make_hmc_kernel
from mlx_mcmc_tpu_torch.kernels.mala import make_mala_kernel
from mlx_mcmc_tpu_torch.kernels.metropolis import make_metropolis_kernel
from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
from mlx_mcmc_tpu_torch.models import eight_schools
from mlx_mcmc_tpu_torch.ops.glm import (
    make_fused_linear_vag,
    make_fused_logistic_vag,
    prepare_fused_linear_data,
    prepare_fused_logistic_data,
)
from mlx_mcmc_tpu_torch.ops.poisson import make_fused_poisson_vag, prepare_fused_poisson_data
from mlx_mcmc_tpu_torch.ops.random import step_draws
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob

STEPS = 3
SEED = 11


def _elementwise(device):
    inv_var = torch.tensor([1.0, 0.25, 4.0], device=device)

    def vag(Z):
        return -0.5 * (Z * Z * inv_var).sum(-1), -Z * inv_var

    vag.graph_safe = True
    return vag, 3, 16, 0.45, 6, 1.0


def _glm(family, device, c=16):
    rng = np.random.default_rng(3)
    n, d = 300, 5
    X = torch.from_numpy((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32))
    beta = rng.standard_normal(d).astype(np.float32)
    if family == "logistic":
        y = (rng.random(n) < 1 / (1 + np.exp(-X.numpy() @ beta))).astype(np.float32)
        data = prepare_fused_logistic_data(X.bfloat16(), torch.from_numpy(y), device=device)
        fused = make_fused_logistic_vag(1.0)
    else:
        y = (X.numpy() @ beta + rng.standard_normal(n)).astype(np.float32)
        data = prepare_fused_linear_data(X.bfloat16(), torch.from_numpy(y), device=device)
        fused = make_fused_linear_vag(1.0)

    def vag(Z):
        return fused(Z, data)

    vag.graph_safe = True
    return vag, d, c, 0.02 if family == "linear" else 0.15, 6, 0.3 if family == "logistic" else 0.1


def _poisson(device, c=16):
    rng = np.random.default_rng(4)
    g, n, k = 6, 20, 2
    X = (0.5 * rng.standard_normal((g, n, k))).astype(np.float32)
    theta = 1.0 + 0.5 * rng.standard_normal(g)
    y = rng.poisson(np.exp(theta[:, None] + X @ np.array([0.3, -0.2]))).astype(np.float32)
    data = prepare_fused_poisson_data(torch.from_numpy(y), torch.from_numpy(X), device=device)
    fused = make_fused_poisson_vag()

    def vag(Z):
        return fused(Z, data)

    vag.graph_safe = True
    return vag, k + 2 + g, c, 0.01, 6, 0.1


def _funnel(device, c=16):
    spec = eight_schools(centered=True, device=device)
    flp, _, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device=device)
    return make_batched_value_and_grad(flp), 10, c, 0.05, 8, 0.3


MODELS = {
    "elementwise": _elementwise,
    "K1": lambda device: _glm("logistic", device),
    "K2": lambda device: _glm("linear", device),
    "K3": _poisson,
    "generic": _funnel,
}


def _transitions(step_fn, vag, dim, c, step_size, depth, init_scale, device):
    """Three transitions from the engine's per-chain draws; every output of
    every step, cloned, and the host syncs."""
    chains = torch.arange(c, device=device)
    tun = Tunables(torch.tensor(step_size, device=device), torch.ones(dim, device=device))
    z0 = init_scale * step_inputs(SEED, chains, 999, tun.inv_mass_diag, 0)[0]
    state = HMCState(z0, *vag(z0))
    outs, syncs = [], []
    for t in range(STEPS):
        r0, U = step_inputs(SEED, chains, t, tun.inv_mass_diag, 1 << (depth - 1))
        state, info, n = step_fn(state, tun, r0, U)
        outs.append([x.clone() for x in (*state, *info)])
        syncs.append(n)
    return outs, syncs


def _eager(model, device, **kw):
    vag, dim, c, eps, depth, scale = model(device)
    _, step_fn = make_nuts_kernel(vag, max_tree_depth=depth, **kw)
    return _transitions(step_fn, vag, dim, c, eps, depth, scale, device)


def _assert_same_bits(a, b):
    for step_a, step_b in zip(a, b):
        for x, y in zip(step_a, step_b):
            assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("model", list(MODELS))
def test_pairs_per_check_give_the_same_bits(model, k):
    ref, ref_syncs = _eager(MODELS[model], "cpu", pairs_per_check=1)
    out, syncs = _eager(MODELS[model], "cpu", pairs_per_check=k)
    _assert_same_bits(ref, out)
    depths = torch.stack([o[9] for o in ref])  # TransitionInfo.tree_depth
    assert int(depths.max()) >= 3, "trees too shallow for k to matter"
    # One check after the root, then one per k pair iterations.
    for n1, nk in zip(ref_syncs, syncs):
        assert nk == 1 + -(-(n1 - 1) // k)


@pytest.mark.parametrize("model", list(MODELS))
def test_static_schedule_gives_the_dynamic_loop_bits(model):
    ref, _ = _eager(MODELS[model], "cpu")
    out, syncs = _eager(MODELS[model], "cpu", static_schedule=True)
    _assert_same_bits(ref, out)
    assert syncs == [0] * STEPS


class _EagerGraph:
    """A stand-in for a captured graph on the CPU: ``replay`` runs the
    captured function again and writes its outputs into the tensors of the
    first run, as a CUDA graph writes into the addresses it captured."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()

    def replay(self):
        for buf, value in zip(_tensors(self.out), _tensors(self.fn())):
            if buf is not value:
                buf.copy_(value)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for item in tree for t in _tensors(item)]


@pytest.fixture
def emulated_capture(monkeypatch):
    def capture(fn, pool=None):
        with _capture.recording() as rec:
            graph = _EagerGraph(fn)
        return graphs.CapturedGraph(graph, rec), graph.out

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "side_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


@pytest.mark.parametrize("static_schedule", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("model", list(MODELS))
def test_graphed_transition_gives_the_eager_bits(model, static_schedule, emulated_capture):
    ref, ref_syncs = _eager(MODELS[model], "cpu", pairs_per_check=graphs.PAIRS_PER_REPLAY,
                            static_schedule=static_schedule)
    vag, dim, c, eps, depth, scale = MODELS[model]("cpu")
    transition = graphs.GraphedTransition(vag, depth, static_schedule)
    out, syncs = _transitions(transition.step, vag, dim, c, eps, depth, scale, "cpu")
    _assert_same_bits(ref, out)
    assert syncs == ref_syncs
    # root, the pairs replays (one per host check after the root's) and the
    # result, per step; the static loop is one replay.
    pairs = STEPS if static_schedule else sum(n - 1 for n in syncs)
    assert transition.graphs["pairs"].replays == pairs
    assert transition.replays == 2 * STEPS + pairs


def test_graphed_transition_refuses_other_shapes(emulated_capture):
    vag, dim, c, eps, depth, scale = _elementwise("cpu")
    transition = graphs.GraphedTransition(vag, depth)
    _transitions(transition.step, vag, dim, c, eps, depth, scale, "cpu")
    with pytest.raises(ValueError, match="captured for"):
        _transitions(transition.step, vag, dim, c + 1, eps, depth, scale, "cpu")


def test_replay_adds_the_recorded_launches():
    def kernel_a():
        pass

    def kernel_b():
        pass

    kernel_a.launches, kernel_b.launches = 0, 5
    pinned = torch.zeros(3)
    with _capture.recording() as rec:  # as during a capture
        _capture.count_launch(kernel_a)
        _capture.count_launch(kernel_a)
        _capture.count_launch(kernel_b)
        _capture.pin(pinned)
    assert (kernel_a.launches, kernel_b.launches) == (0, 5)  # a capture launches nothing

    class Stub:
        replays = 0

        def replay(self):
            self.replays += 1

    graph = graphs.CapturedGraph(Stub(), rec)
    for _ in range(3):
        graph.replay()
    assert (kernel_a.launches, kernel_b.launches) == (6, 8)
    assert graph.graph.replays == graph.replays == 3
    assert graph.pinned == [pinned]
    _capture.count_launch(kernel_a)  # eager, outside a recording
    assert kernel_a.launches == 7


def test_vags_declare_whether_graphs_capture_them():
    assert graphs.captures(make_fused_logistic_vag())
    assert graphs.captures(make_fused_linear_vag())
    assert graphs.captures(make_fused_poisson_vag())
    # The generic autograd value+grad takes the model's declaration.
    for centered in (True, False):
        spec = eight_schools(centered=centered, device="cpu")
        flp, _, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device="cpu")
        assert graphs.captures(make_batched_value_and_grad(flp))

    def undeclared(params):
        return -0.5 * (params["x"] ** 2).sum()

    flp, _, _ = make_flat_logprob(undeclared, {"x": torch.zeros(2)}, device="cpu")
    assert not graphs.captures(make_batched_value_and_grad(flp))
    assert not graphs.captures(lambda Z: (Z.sum(-1), Z))


def _fixed_trip(kernel, vag):
    """``(init_fn, step_fn, draws)`` of HMC (8 leapfrogs), MALA or Metropolis
    (on ``vag``'s value) over ``vag``, with the engine's per-step inputs."""
    if kernel == "hmc":
        init_fn, step_fn = make_hmc_kernel(vag, num_leapfrog_steps=8)
        return init_fn, step_fn, lambda chains, t, tun: step_inputs(
            SEED, chains, t, tun.inv_mass_diag, 1)
    if kernel == "mala":
        init_fn, step_fn = make_mala_kernel(vag)
        return init_fn, step_fn, lambda chains, t, tun: step_draws(
            SEED, chains, t, tun.inv_mass_diag.shape[0], 1)

    def value(Z):
        return vag(Z)[0]

    init_fn, step_fn = make_metropolis_kernel(value)
    return init_fn, step_fn, lambda chains, t, tun: step_draws(
        SEED, chains, t, tun.inv_mass_diag.shape[0], 1)


# HMC's step and the Metropolis and MALA proposal scales as multiples of
# each model's NUTS step size: each takes some proposals and rejects others.
_STEP_SCALE = {("hmc", "K2"): 1.0, ("hmc", None): 2.0, ("metropolis", None): 4.0,
               ("mala", None): 2.0, ("mala", "K2"): 8.0, ("mala", "K3"): 8.0,
               ("mala", "generic"): 8.0}


def _fixed_trip_steps(kernel, model, device, graphed):
    """Three transitions of ``kernel`` on ``MODELS[model]`` at fixed
    tunables, eager or through :class:`graphs.GraphedStep`: every output,
    cloned."""
    vag, dim, c, eps, _, scale = MODELS[model](device)
    eps *= _STEP_SCALE.get((kernel, model), _STEP_SCALE[(kernel, None)])
    init_fn, step_fn, draws = _fixed_trip(kernel, vag)
    chains = torch.arange(c, device=device)
    tun = Tunables(torch.tensor(eps, device=device),
                   torch.ones(dim, device=device))
    state = init_fn(scale * step_inputs(SEED, chains, 999, tun.inv_mass_diag, 0)[0])
    graph = graphs.GraphedStep(step_fn) if graphed else None
    outs = []
    for t in range(STEPS):
        x, U = draws(chains, t, tun)
        state, info, syncs = (graph.step if graphed else step_fn)(state, tun, x, U)
        assert syncs == 0
        outs.append([v.clone() for v in (*state, *info)])
    return outs, graph


@pytest.mark.parametrize("kernel", ["hmc", "metropolis", "mala"])
@pytest.mark.parametrize("model", list(MODELS))
def test_graphed_step_gives_the_eager_bits(kernel, model, emulated_capture):
    ref, _ = _fixed_trip_steps(kernel, model, "cpu", graphed=False)
    out, graph = _fixed_trip_steps(kernel, model, "cpu", graphed=True)
    _assert_same_bits(ref, out)
    # the first step runs eagerly as the capture's warm-up; one replay per later step
    assert graph.replays == STEPS - 1
    accepted = torch.stack([o[-7] for o in ref])  # TransitionInfo.is_accepted
    assert accepted.any() and not accepted.all()


def test_graphed_step_refuses_other_shapes(emulated_capture):
    vag = _elementwise("cpu")[0]
    _, step_fn = make_hmc_kernel(vag, num_leapfrog_steps=2)
    graph = graphs.GraphedStep(step_fn)
    tun = Tunables(torch.tensor(0.3), torch.ones(3))
    for c in (4, 4, 5):
        z = torch.zeros(c, 3)
        state = HMCState(z, *vag(z))
        x, U = step_inputs(SEED, torch.arange(c), 0, tun.inv_mass_diag, 1)
        if c == 5:
            with pytest.raises(ValueError, match="captured for"):
                graph.step(state, tun, x, U)
        else:
            graph.step(state, tun, x, U)


# ChEES's counts for the three steps: the leapfrog graph replays 1, 4 and 2
# times, so a replay count baked into a graph would show.
_CHEES_COUNTS = (1, 4, 2)


def _chees_steps(model, device, graphed):
    """Three ChEES transitions on ``MODELS[model]`` at fixed tunables and
    the counts above, eager or through :class:`graphs.GraphedTrajectory`."""
    vag, dim, c, eps, _, scale = MODELS[model](device)
    init_fn, step_fn = make_chees_kernel(vag)
    chains = torch.arange(c, device=device)
    tun = Tunables(torch.tensor(eps, device=device), torch.ones(dim, device=device))
    state = init_fn(scale * step_inputs(SEED, chains, 999, tun.inv_mass_diag, 0)[0])
    graph = graphs.GraphedTrajectory(make_chees_parts(vag)) if graphed else None
    outs = []
    for t, n in enumerate(_CHEES_COUNTS):
        r0, U = step_inputs(SEED, chains, t, tun.inv_mass_diag, 1)
        state, info, syncs = (graph.step if graphed else step_fn)(state, tun, r0, U, n)
        assert syncs == 0
        outs.append([v.clone() for v in (*state, *info)])
    return outs, graph


@pytest.mark.parametrize("model", list(MODELS))
def test_graphed_trajectory_gives_the_eager_bits(model, emulated_capture):
    ref, _ = _chees_steps(model, "cpu", graphed=False)
    out, graph = _chees_steps(model, "cpu", graphed=True)
    _assert_same_bits(ref, out)
    # the first step runs eagerly; then start, n leapfrogs and end per step
    assert graph.graphs["leapfrog"].replays == sum(_CHEES_COUNTS[1:])
    assert graph.replays == sum(n + 2 for n in _CHEES_COUNTS[1:])
    steps = torch.stack([o[8] for o in out])  # ChEESInfo.num_integration_steps
    assert steps.tolist() == [[n] * steps.shape[1] for n in _CHEES_COUNTS]


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("static_schedule", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("model", list(MODELS))
def test_graphs_give_the_eager_bits_on_the_card(model, static_schedule):
    _need_gpu()
    ref, _ = _eager(MODELS[model], "cuda")
    vag, dim, c, eps, depth, scale = MODELS[model]("cuda")
    transition = graphs.GraphedTransition(vag, depth, static_schedule)
    out, syncs = _transitions(transition.step, vag, dim, c, eps, depth, scale, "cuda")
    _assert_same_bits(ref, out)
    assert transition.replays > 0
    if static_schedule:
        assert syncs == [0] * STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("model", list(MODELS))
def test_graphed_trajectory_gives_the_eager_bits_on_the_card(model):
    _need_gpu()
    ref, _ = _chees_steps(model, "cuda", graphed=False)
    out, graph = _chees_steps(model, "cuda", graphed=True)
    _assert_same_bits(ref, out)
    assert graph.replays == sum(n + 2 for n in _CHEES_COUNTS[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["hmc", "metropolis", "mala"])
@pytest.mark.parametrize("model", list(MODELS))
def test_graphed_step_gives_the_eager_bits_on_the_card(kernel, model):
    _need_gpu()
    ref, _ = _fixed_trip_steps(kernel, model, "cuda", graphed=False)
    out, graph = _fixed_trip_steps(kernel, model, "cuda", graphed=True)
    _assert_same_bits(ref, out)
    assert graph.replays == STEPS - 1
