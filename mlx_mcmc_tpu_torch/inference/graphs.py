"""Transitions as captured CUDA graphs: the port's ``jax.jit``.

The reference compiles a whole transition into one program: its pair loop
is a ``lax.while_loop`` (``mlx_mcmc_tpu/kernels/nuts.py:427``) or, with
``static_schedule``, a fixed-trip ``lax.scan`` (``:408-425``). Run eagerly,
the port's loop launches every op of every pair iteration from the host
(hundreds of launches) and reads ``active.any()`` once per iteration. Here
the parts of :func:`mlx_mcmc_tpu_torch.kernels.nuts.make_nuts_parts` are
captured once per static configuration as ``torch.cuda.CUDAGraph``s, all in
one memory pool, and replayed:

- ``root``: the peeled root leaf, from the step's inputs (copied into
  static buffers: position, log_prob, grad, ``r0``, ``U``, ``step_size``
  and ``inv_mass_diag``) into the carry buffers, and whether any chain is
  active;
- ``pairs``: :data:`PAIRS_PER_REPLAY` pair iterations on the carry buffers
  in place, and whether any chain is still active, which the host reads
  once per replay; with ``static_schedule``, the whole fixed-trip loop
  (``2**(max_tree_depth-1) - 1`` iterations) and no host read;
- ``result``: the new state and ``TransitionInfo`` into static output
  buffers.

The same kernels run on the same inputs in the same order as in the eager
loop, so the draws are bit-identical to it: surplus pair iterations change
nothing (the masked freeze). The Philox draws, the adaptation update and
the draw store stay outside the graphs, as eager launches.

A fixed-trip transition (HMC's leapfrogs, a Metropolis or MALA proposal)
has no loop to check: :class:`GraphedStep` captures it whole as one graph,
from the step's inputs in static buffers to its ``TransitionInfo``, with no
host read inside. A ChEES transition's leapfrog count is the same for every
chain but changes from step to step, and a graph's trip count is fixed:
:class:`GraphedTrajectory` captures its start, one leapfrog and its end,
and replays the leapfrog graph as often as the count the caller read.

A value+grad is captured only if it says it can be with ``graph_safe =
True``: the fused GLM and Poisson ones do. Any other runs eagerly; the
engine reads the attribute (:func:`captures`) and never tries a capture to
find out. On the card a capture or a replay that fails raises: nothing is
retried eagerly.

A captured kernel launch keeps raw pointers: the data, the kernel's launch
workspace and the tensor maps in its parameters, which encode workspace
addresses. Each :class:`CapturedGraph` holds what its capture pinned
(``_capture.pin``), so a workspace cache that evicts an entry frees no
memory a graph still reads. The kernel wrappers count a captured launch in
the recording, not in their ``launches``; every replay adds the recorded
counts, so ``launches`` counts launches on the card either way.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch

from mlx_mcmc_tpu_torch import _capture
from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.kernels.chees import ChEESCarry, ChEESParts
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
from mlx_mcmc_tpu_torch.kernels.nuts import NutsInputs, _NutsCarry, make_nuts_parts

# Pair iterations per replay of the pairs graph. Measured on the H100 at 1,
# 2, 4 and 8 (`python -m mlx_mcmc_tpu_torch.bench ksweep`, PERF.md §6):
# 1 gave the shortest walls on glm100_fused (6.33 s against 8.17-13.89)
# and glm1000_fused (8.15 against 8.58-9.44) and the least in sum; a surplus
# iteration (every chain's two leapfrogs) costs the card more than the host
# check it saves. poisson1000_cov (~32 iterations a step) was 7% faster at 4.
PAIRS_PER_REPLAY = 1


def captures(value_and_grad: Callable) -> bool:
    """Whether ``value_and_grad`` declared that CUDA graphs may capture it."""
    return bool(getattr(value_and_grad, "graph_safe", False))


class CapturedGraph:
    """A captured graph, what its capture recorded and how often it ran:
    each :meth:`replay` adds the recorded launches to each kernel
    wrapper's ``launches``."""

    def __init__(self, graph, recording: _capture.Recording):
        self.graph = graph
        self.launches = dict(recording.launches)
        self.pinned = recording.pinned
        self.replays = 0

    def replay(self) -> None:
        self.graph.replay()
        for wrapper, n in self.launches.items():
            wrapper.launches += n
        self.replays += 1


def capture(fn: Callable, pool=None):
    """``(CapturedGraph, fn's outputs)``: ``fn`` captured on the current
    device, its kernel launches recorded. Adds one to ``capture.count``."""
    graph = torch.cuda.CUDAGraph()
    with _capture.recording() as rec:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    capture.count += 1
    return CapturedGraph(graph, rec), out


capture.count = 0


@contextlib.contextmanager
def side_stream(device):
    """Run the body on a side stream that follows the current one, which
    then waits for it: the eager warm-up before a capture."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        yield
    torch.cuda.current_stream(device).wait_stream(side)


class GraphedTransition:
    """One NUTS transition for ``value_and_grad``, replayed as CUDA graphs.

    ``step(state, tunables, r0, U) -> (state, info, host_syncs)`` as the
    eager ``step_fn`` of ``kernels/nuts.py`` gives them. The first step
    fixes the static configuration (chains, width, dtypes and device of
    the inputs) and captures the graphs, after one eager warm-up of every
    part on a side stream; a later step with other shapes raises. The
    returned state and info are the graphs' static outputs: the next step
    overwrites them, so a caller that keeps them clones them.
    """

    def __init__(self, value_and_grad: Callable, max_tree_depth: int = 10,
                 static_schedule: bool = False):
        self.parts = make_nuts_parts(value_and_grad, max_tree_depth)
        self.k = PAIRS_PER_REPLAY
        self.static_schedule = static_schedule
        self.graphs = None

    @property
    def replays(self) -> int:
        """Replays of every graph so far."""
        return sum(g.replays for g in self.graphs.values()) if self.graphs else 0

    def step(self, state: HMCState, tunables: Tunables, r0: torch.Tensor, U: torch.Tensor):
        values = NutsInputs(state.position, state.log_prob, state.grad, r0, U,
                            tunables.step_size, tunables.inv_mass_diag)
        if self.graphs is None:
            self._capture(values)
        for name, buf, value in zip(NutsInputs._fields, self.inputs, values):
            if (buf.shape != value.shape or buf.dtype != value.dtype
                    or buf.device != value.device):
                raise ValueError(
                    f"{name}: the graphs were captured for {buf.dtype} {tuple(buf.shape)} on "
                    f"{buf.device}, got {value.dtype} {tuple(value.shape)} on {value.device}")
            buf.copy_(value)
        self.graphs["root"].replay()
        if self.static_schedule:
            self.graphs["pairs"].replay()
            host_syncs = 0
        else:
            host_syncs = 1
            any_active = self.any_root
            while bool(any_active):
                self.graphs["pairs"].replay()
                host_syncs += 1
                any_active = self.any_pairs
        self.graphs["result"].replay()
        return self.state_out, self.info_out, host_syncs

    def _capture(self, values: NutsInputs) -> None:
        self.inputs = NutsInputs(*(v.clone(memory_format=torch.contiguous_format)
                                   for v in values))
        device = self.inputs.position.device
        parts = self.parts
        k = parts.static_pairs if self.static_schedule else self.k

        # Warm-up, eagerly on a side stream, as torch.cuda.graph requires:
        # it also makes what must exist before a capture (the kernels'
        # libraries, launch workspaces and shared-memory limits, the
        # checkpoint slot tables).
        with side_stream(device):
            frame, carry = parts.root(self.inputs)
            carry, _ = parts.pairs(frame, carry, k)
            parts.result(frame, carry)
        del frame, carry

        def root():
            frame, carry = parts.root(self.inputs)
            # One buffer per field (the root's carry shares storage between
            # fields, which the in-place update of ``pairs`` must not).
            carry = _NutsCarry(*(t.clone() for t in carry))
            return frame, carry, parts.active(carry).any()

        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        graphs["root"], (frame, carry, self.any_root) = capture(root, pool)

        def pairs():
            new, any_active = parts.pairs(frame, carry, k)
            for buf, value in zip(carry, new):
                buf.copy_(value)
            return any_active

        graphs["pairs"], self.any_pairs = capture(pairs, pool)

        def result():
            # The state as views of a copy of the proposal, laid out as the
            # eager step returns it: the adaptation's sums over chains read
            # the position, and on the card their order follows its strides.
            proposal = carry.proposal.clone()
            state, info = parts.result(frame, carry._replace(proposal=proposal))
            ptr = proposal.untyped_storage().data_ptr()
            return state, TransitionInfo(*(
                t if t.untyped_storage().data_ptr() == ptr else t.clone() for t in info))

        graphs["result"], (self.state_out, self.info_out) = capture(result, pool)
        self.graphs = graphs


class GraphedStep:
    """A fixed-trip transition ``step_fn(state, tunables, x, U) -> (state,
    info, 0)`` (``kernels/hmc.py``, ``kernels/metropolis.py``) as one CUDA
    graph: the state, the random inputs ``x`` and ``U`` and the tunables
    are copied into static buffers, then the graph replays the whole step.

    The first step runs eagerly on a side stream, as the warm-up that a
    capture needs, and its outputs are that step's result; the graph is
    captured after it, launching nothing, and every later step is one
    replay. So each transition launches its kernels once and ``replays``
    is the step count less one. A later step with other shapes raises. The
    returned state and info are the graph's static outputs, which the next
    step overwrites.
    """

    def __init__(self, step_fn: Callable):
        self.step_fn = step_fn
        self.graph = None

    @property
    def replays(self) -> int:
        return self.graph.replays if self.graph is not None else 0

    def _run(self, state_type, values):
        n = len(state_type._fields)
        x, U, step_size, inv_mass_diag = values[n:]
        state, info, _ = self.step_fn(state_type(*values[:n]), Tunables(step_size, inv_mass_diag),
                                      x, U)
        return state, info

    def step(self, state, tunables: Tunables, x: torch.Tensor, U: torch.Tensor):
        values = (*state, x, U, tunables.step_size, tunables.inv_mass_diag)
        if self.graph is None:
            return self._capture(type(state), values)
        _check_inputs(self.inputs, values)
        self.graph.replay()
        return self.state_out, self.info_out, 0

    def _capture(self, state_type, values):
        self.inputs = tuple(v.clone(memory_format=torch.contiguous_format) for v in values)
        with side_stream(self.inputs[0].device):
            first = self._run(state_type, self.inputs)
        self.graph, (self.state_out, self.info_out) = capture(
            lambda: self._run(state_type, self.inputs), torch.cuda.graph_pool_handle())
        return (*first, 0)


def _check_inputs(bufs, values) -> None:
    for buf, value in zip(bufs, values):
        if buf.shape != value.shape or buf.dtype != value.dtype or buf.device != value.device:
            raise ValueError(
                f"the graphs were captured for {buf.dtype} {tuple(buf.shape)} on "
                f"{buf.device}, got {value.dtype} {tuple(value.shape)} on {value.device}")
        buf.copy_(value)


class GraphedTrajectory:
    """A ChEES transition (``kernels/chees.py``) as three CUDA graphs:
    ``start`` (from the state, momenta, uniforms and tunables, copied into
    static buffers, to the integration carry), ``leapfrog`` (one leapfrog
    on the carry buffers in place) and ``end`` (the new state and
    ``ChEESInfo`` into static output buffers).

    ``step(state, tunables, r0, U, num_steps) -> (state, info, 0)`` replays
    ``start``, ``num_steps`` times ``leapfrog`` and ``end``: the kernels
    of the eager ``step_fn`` in the same order on the same inputs, so the
    same bits. The first step runs eagerly on a side stream, as the
    warm-up that a capture needs, and its outputs are that step's result;
    the graphs are captured after it, launching nothing. A later step with
    other shapes raises. The returned state and info are static outputs,
    which the next step overwrites.
    """

    def __init__(self, parts: ChEESParts):
        self.parts = parts
        self.graphs = None

    @property
    def replays(self) -> int:
        return sum(g.replays for g in self.graphs.values()) if self.graphs else 0

    def step(self, state: HMCState, tunables: Tunables, r0: torch.Tensor, U: torch.Tensor,
             num_steps: int):
        values = (*state, r0, U, tunables.step_size, tunables.inv_mass_diag)
        if self.graphs is None:
            return self._capture(values, num_steps)
        _check_inputs(self.inputs, values)
        self.graphs["start"].replay()
        for _ in range(num_steps):
            self.graphs["leapfrog"].replay()
        self.graphs["end"].replay()
        return self.state_out, self.info_out, 0

    def _capture(self, values, num_steps: int):
        self.inputs = tuple(v.clone(memory_format=torch.contiguous_format) for v in values)
        parts, inputs = self.parts, self.inputs
        tun = Tunables(*inputs[-2:])
        state = HMCState(*inputs[:3])
        r0, U = inputs[3:5]
        with side_stream(inputs[0].device):
            frame, carry = parts.start(state, tun, r0)
            for _ in range(num_steps):
                carry = parts.leapfrog(carry, tun)
            first = parts.end(frame, carry, tun, U)
        del frame, carry

        def start():
            frame, carry = parts.start(state, tun, r0)
            # carry buffers of their own: ``leapfrog`` updates them in place,
            # and ``end`` reads the unchanged inputs for rejected chains
            return frame, ChEESCarry(*(t.clone() for t in carry))

        pool = torch.cuda.graph_pool_handle()
        graphs = {}
        graphs["start"], (frame, carry) = capture(start, pool)

        def one_leapfrog():
            for buf, value in zip(carry, parts.leapfrog(carry, tun)):
                buf.copy_(value)
            return carry

        graphs["leapfrog"], _ = capture(one_leapfrog, pool)
        graphs["end"], (self.state_out, self.info_out) = capture(
            lambda: parts.end(frame, carry, tun, U), pool)
        self.graphs = graphs
        return (*first, 0)
