"""No-U-Turn Sampler, iterative multinomial form, batched over chains.

Counterpart of ``mlx_mcmc_tpu/kernels/nuts.py``, ported whole: the peeled
root leaf, the flat paired-leaf body (two leapfrogs per iteration),
popcount-indexed checkpoint slots with the masked U-turn check, masked
checkpoint writes, the proposal carry with its cached density and gradient,
the NaN guards on every take/move probability, and ``DELTA_MAX = 1000``.

Differences that come from PyTorch rather than from the algorithm:

- The step takes its randomness as tensors: ``r0`` ``(C, D)`` momenta and
  ``U`` ``(C, 2**(max_tree_depth-1), 4)`` uniforms (row 0 feeds the root,
  row p the p-th pair iteration), so a test can replay JAX's draws exactly.
- The tree loop is a masked freeze, as the reference's ``static_schedule``
  scan is: each pair iteration computes which chains are still active and
  finished chains carry through unchanged, so surplus iterations change
  nothing and the draws equal the dynamic ``while_loop``'s. The transition
  comes in three parts (:func:`make_nuts_parts`): the peeled root, ``pairs
  (frame, carry, k)``, k pair iterations that read nothing on the host, and
  the result. ``step_fn`` checks ``active.any()`` on the host once after the
  root and once after every ``pairs`` call (each check is one
  device-to-host sync; ``step_fn`` returns how many it made), or, with
  ``static_schedule=True``, runs the reference's fixed trip count of
  ``2**(max_tree_depth-1) - 1`` pair iterations and reads nothing.
  ``inference/graphs.py`` captures the same parts as CUDA graphs.
- Per-chain uniform-slot selection is a plain gather (the reference's masked
  reduce exists for TPU vmap lowering), and so are the checkpoint slots:
  popcount tables over the leaf index stand in for bit arithmetic.
- Eager PyTorch pays per op launched, so the loop carry packs each
  integration point into one tensor and folds the freeze into the selects
  the body makes anyway (see ``body``).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from mlx_mcmc_tpu_torch.kernels.base import TransitionInfo, Tunables
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
from mlx_mcmc_tpu_torch.kernels.integrators import (
    IntegratorState,
    leapfrog,
    total_energy,
)
from mlx_mcmc_tpu_torch.ops.math import row_sum

DELTA_MAX = 1000.0  # max energy error before declaring divergence


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _slot_tables(max_tree_depth: int, device):
    """Checkpoint slots as lookup tables over a subtree's leaf index.

    ``write[m]`` (one-hot over the ``max_tree_depth`` slots) marks where an
    even leaf ``m`` stores: slot ``popcount(m)``. ``check[n]`` marks the
    slots an odd leaf ``n`` checks for U-turns:
    ``[idx_max - trailing_ones(n) + 1, idx_max]`` with
    ``idx_max = popcount(n >> 1)``. Every slot in that range was written
    earlier in the same subtree, so the buffers need no per-subtree zeroing.
    Leaf indices stay below ``2**max_tree_depth``; torch has no popcount op,
    and one gather per table replaces the bit arithmetic in the loop.
    """
    size = 1 << max_tree_depth
    write = torch.zeros((size, max_tree_depth), dtype=torch.bool)
    check = torch.zeros((size, max_tree_depth), dtype=torch.bool)
    for leaf in range(size):
        slot = _popcount(leaf)
        if slot < max_tree_depth:
            write[leaf, slot] = True
        idx_max = _popcount(leaf >> 1)
        idx_min = idx_max - (_popcount(leaf ^ (leaf + 1)) - 1) + 1
        for t in range(max(idx_min, 0), min(idx_max + 1, max_tree_depth)):
            check[leaf, t] = True
    return write.to(device), check.to(device)


def _select(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``where(mask, a, b)`` with a per-chain ``(C,)`` mask."""
    return torch.where(mask.view(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _nan_to_zero(p: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(p), 0.0, p)


def _is_turning(r_sum, r_first, r_last, inv_mass_diag) -> torch.Tensor:
    """Generalized U-turn criterion, per chain."""
    v_first = inv_mass_diag * r_first
    v_last = inv_mass_diag * r_last
    return (row_sum(r_sum * v_first) <= 0.0) | (row_sum(r_sum * v_last) <= 0.0)


def _leaf_turning_check(check_mask, r_sum, r_leaf, r_ckpts, r_sum_ckpts, inv_mass):
    """U-turn checks of every subtree whose rightmost leaf is this odd leaf,
    against the checkpointed left edges, evaluated for all slots at once
    under ``check_mask`` (C, T) from :func:`_slot_tables`."""
    sub_sum = r_sum[:, None, :] - r_sum_ckpts + r_ckpts  # (C, T, D)
    v_first = (inv_mass if inv_mass.dim() == 1 else inv_mass[:, None, :]) * r_ckpts
    v_leaf = inv_mass * r_leaf
    turning_t = (row_sum(sub_sum * v_first) <= 0.0) | (
        row_sum(sub_sum * v_leaf[:, None, :]) <= 0.0
    )
    return (turning_t & check_mask).any(-1)


def _pack(state: IntegratorState) -> torch.Tensor:
    """One (C, 3D+1) tensor ``[z | grad | log_prob | r]``, so that a select
    of a whole integration point is one op; its first 2D+1 columns are the
    proposal ``[z | grad | log_prob]``."""
    return torch.cat([state.z, state.grad, state.log_prob[:, None], state.r], dim=1)


def _unpack(p: torch.Tensor, d: int) -> IntegratorState:
    return IntegratorState(z=p[:, :d], r=p[:, 2 * d + 1:], log_prob=p[:, 2 * d], grad=p[:, d:2 * d])


class _NutsCarry(NamedTuple):
    """Loop state: the sampled trajectory (tree) and the in-flight subtree,
    advanced one even+odd leaf pair per iteration. Every field leads with
    the chain axis. Integration points are packed (:func:`_pack`):
    ``left``, ``right`` and ``sub_last`` are (C, 3D+1), the proposals
    (C, 2D+1)."""

    left: torch.Tensor
    right: torch.Tensor
    proposal: torch.Tensor
    log_weight: torch.Tensor  # log sum_leaves exp(E0 - E); root contributes 0
    r_sum: torch.Tensor  # (C, D) momentum sum over all leaves incl. root
    depth: torch.Tensor  # i32 completed doublings
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_accept: torch.Tensor
    num_leaves: torch.Tensor  # i32 leapfrog steps taken
    sub_last: torch.Tensor  # latest integration point
    sub_proposal: torch.Tensor
    sub_log_weight: torch.Tensor
    sub_r_sum: torch.Tensor
    sub_leaf: torch.Tensor  # i64 leaves built in the current subtree
    going_right: torch.Tensor  # bool direction of the current subtree
    iter_idx: torch.Tensor  # i64 body-iteration counter (uniform-table row)
    ckpts: torch.Tensor  # (C, max_tree_depth, 2D) even-leaf [momentum | prefix sum]


class NutsInputs(NamedTuple):
    """A transition's inputs: the state, its random draws and the tunables.
    On the card they are the static input buffers of the transition's CUDA
    graphs (``inference/graphs.py``)."""

    position: torch.Tensor  # (C, D)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D)
    r0: torch.Tensor  # (C, D) momenta
    U: torch.Tensor  # (C, 2**(max_tree_depth-1), 4) uniforms
    step_size: torch.Tensor  # 0-d, or (C,) per row (kernels/base.py)
    inv_mass_diag: torch.Tensor  # (D,), or (C, D) per row


class NutsFrame(NamedTuple):
    """What every pair iteration reads and none writes."""

    inputs: NutsInputs
    energy0: torch.Tensor  # (C,) Hamiltonian at the start
    rows: torch.Tensor  # (C,) chain indices, for the uniform-table gather


class NutsParts(NamedTuple):
    """One transition in the parts that ``step_fn`` runs and CUDA graphs
    capture. ``root(inputs) -> (frame, carry)``: the peeled root leaf.
    ``pairs(frame, carry, k) -> (carry, any_active)``: k pair iterations,
    each on the chains still active at its start, with a 0-d bool tensor
    saying whether any chain is active after them; nothing is read on the
    host. ``result(frame, carry) -> (state, info)``. ``active(carry)``: the
    chains whose trees are still growing. ``static_pairs``: the pair
    iterations of the reference's ``static_schedule``,
    ``2**(max_tree_depth-1) - 1``, enough for a tree at the depth cap."""

    root: Callable
    pairs: Callable
    result: Callable
    active: Callable
    static_pairs: int


def make_nuts_parts(
    value_and_grad: Callable[[torch.Tensor], tuple],
    max_tree_depth: int = 10,
    max_delta_energy: float = DELTA_MAX,
) -> NutsParts:
    """The parts of batched iterative multinomial NUTS for
    ``value_and_grad(Z (C, D)) -> (log_prob (C,), grad (C, D))``."""
    n_slots = 1 << (max_tree_depth - 1)
    tables = {}

    def slot_tables(device):
        if device not in tables:
            tables[device] = _slot_tables(max_tree_depth, device)
        return tables[device]

    def leaf_energy(frame: NutsFrame, new: IntegratorState):
        delta = total_energy(new, frame.inputs.inv_mass_diag) - frame.energy0
        leaf_div = delta > max_delta_energy
        log_w = -delta  # multinomial log weight, relative to E0
        accept_stat = torch.exp(torch.clamp(-delta, max=0.0))
        return leaf_div, log_w, accept_stat

    def signed_eps(frame: NutsFrame, going_right):
        eps = frame.inputs.step_size
        return torch.where(going_right, eps, -eps)[:, None]

    def active(c: _NutsCarry) -> torch.Tensor:
        return ~c.turning & ~c.diverging & (c.depth < max_tree_depth)

    def root(x: NutsInputs):
        """The peeled root doubling: one leaf, so every pair iteration
        processes exactly one even+odd leaf pair."""
        inv_mass = x.inv_mass_diag
        num_chains, dim = x.position.shape
        device = x.position.device
        prop = 2 * dim + 1  # proposal columns of a packed point
        start = IntegratorState(x.position, x.r0, x.log_prob, x.grad)
        frame = NutsFrame(x, total_energy(start, inv_mass), torch.arange(num_chains, device=device))

        u0 = x.U[:, 0]
        going_right0 = u0[:, 0] < 0.5
        start_p = _pack(start)
        new0 = leapfrog(start, signed_eps(frame, going_right0), inv_mass, value_and_grad)
        new0_p = _pack(new0)
        div0, lw0, acc0 = leaf_energy(frame, new0)
        p_move0 = _nan_to_zero(torch.exp(torch.clamp(lw0, max=0.0)))
        move0 = ~div0 & (u0[:, 3] < p_move0)
        left0 = _select(going_right0, start_p, new0_p)
        right0 = _select(going_right0, new0_p, start_p)
        r_sum0 = x.r0 + new0.r
        turning0 = ~div0 & _is_turning(
            r_sum0, _unpack(left0, dim).r, _unpack(right0, dim).r, inv_mass
        )

        i32 = dict(dtype=torch.int32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        carry0 = _NutsCarry(
            left=left0,
            right=right0,
            proposal=_select(move0, new0_p[:, :prop], start_p[:, :prop]),
            log_weight=torch.logaddexp(torch.zeros_like(lw0), lw0),
            r_sum=r_sum0,
            depth=torch.ones((num_chains,), **i32),
            turning=turning0,
            diverging=div0,
            sum_accept=acc0,
            num_leaves=torch.ones((num_chains,), **i32),
            sub_last=new0_p,
            sub_proposal=new0_p[:, :prop],
            sub_log_weight=torch.full_like(lw0, -math.inf),
            sub_r_sum=torch.zeros_like(x.r0),
            sub_leaf=torch.zeros((num_chains,), **i64),
            going_right=torch.zeros((num_chains,), dtype=torch.bool, device=device),
            iter_idx=torch.ones((num_chains,), **i64),
            ckpts=x.r0.new_zeros((num_chains, max_tree_depth, 2 * dim)),
        )
        return frame, carry0

    def body(frame: NutsFrame, c: _NutsCarry, active: torch.Tensor) -> _NutsCarry:
        """One leaf pair for every chain; chains not ``active`` keep their
        carry (the masked freeze): every field is merged under ``active``,
        or under ``complete``, which implies it, or (``iter_idx``, the
        checkpoint write) advanced by ``active`` alone."""
        x = frame.inputs
        inv_mass = x.inv_mass_diag
        dim = x.position.shape[1]
        prop = 2 * dim + 1
        write_slots, check_slots = slot_tables(x.position.device)
        starting = c.sub_leaf == 0  # first pair of a new subtree?
        # Frozen chains may sit past the table's end; their result is
        # discarded, so the clamp only keeps the gather legal.
        u4 = x.U[frame.rows, torch.clamp(c.iter_idx, max=n_slots - 1)]
        going_right = torch.where(starting, u4[:, 0] < 0.5, c.going_right)
        eps_signed = signed_eps(frame, going_right)

        # Integrate from the tree's outgoing edge when starting a
        # subtree, else from the last integration point.
        base = _select(starting, _select(going_right, c.right, c.left), c.sub_last)
        new1 = leapfrog(_unpack(base, dim), eps_signed, inv_mass, value_and_grad)  # leaf A
        div1, lw1, acc1 = leaf_energy(frame, new1)
        new1_p = _pack(new1)
        new2 = leapfrog(new1, eps_signed, inv_mass, value_and_grad)  # leaf B
        div2, lw2, acc2 = leaf_energy(frame, new2)
        new2_p = _pack(new2)
        # If leaf A diverged the unpaired loop would have stopped before
        # B: gate every contribution of B on ~div1.
        b_valid = ~div1
        div2 = b_valid & div2

        # Progressive uniform-multinomial proposal update, both leaves.
        prev_lw = torch.where(starting, -math.inf, c.sub_log_weight)
        lw_a = torch.logaddexp(prev_lw, lw1)
        p_take1 = _nan_to_zero(torch.exp(lw1 - lw_a))
        take1 = ~div1 & (u4[:, 1] < p_take1)
        lw_b = torch.logaddexp(lw_a, lw2)
        p_take2 = _nan_to_zero(torch.exp(lw2 - lw_b))
        take2 = b_valid & ~div2 & (u4[:, 2] < p_take2)
        sub_lw = torch.where(b_valid, lw_b, lw_a)
        sub_proposal = _select(
            take2, new2_p[:, :prop], _select(take1, new1_p[:, :prop], c.sub_proposal)
        )

        leaf_a = torch.where(starting, 0, c.sub_leaf)  # even leaf index
        leaf_b = leaf_a + 1
        sum_a = torch.where(starting[:, None], 0.0, c.sub_r_sum) + new1.r
        sum_b = sum_a + torch.where(b_valid[:, None], new2.r, 0.0)

        # Checkpoints: leaf A stores (masked write), leaf B checks.
        hit = (write_slots[leaf_a] & active[:, None])[:, :, None]
        ckpts = torch.where(hit, torch.cat([new1.r, sum_a], dim=1)[:, None, :], c.ckpts)
        sub_turn = b_valid & _leaf_turning_check(
            check_slots[leaf_b], sum_b, new2.r, ckpts[..., :dim], ckpts[..., dim:], inv_mass
        )

        # The subtree completes at 2^depth leaves or when it stops early.
        target = torch.ones_like(c.depth) << c.depth
        pair_div = div1 | div2
        complete = ((leaf_b + 1 >= target) | sub_turn | pair_div) & active
        valid = ~sub_turn & ~pair_div

        # Merge into the tree where complete; the biased progressive
        # transition favours the new half-trajectory.
        p_move = _nan_to_zero(torch.exp(torch.clamp(sub_lw - c.log_weight, max=0.0)))
        move = complete & valid & (u4[:, 3] < p_move)
        left = _select(complete & ~going_right, new2_p, c.left)
        right = _select(complete & going_right, new2_p, c.right)
        r_sum_tree = torch.where(complete[:, None], c.r_sum + sum_b, c.r_sum)
        turning_full = _is_turning(
            r_sum_tree, _unpack(left, dim).r, _unpack(right, dim).r, inv_mass
        )

        return _NutsCarry(
            left=left,
            right=right,
            proposal=_select(move, sub_proposal, c.proposal),
            log_weight=torch.where(
                complete, torch.logaddexp(c.log_weight, sub_lw), c.log_weight
            ),
            r_sum=r_sum_tree,
            depth=c.depth + complete.int(),
            turning=torch.where(complete, sub_turn | (valid & turning_full), c.turning),
            diverging=torch.where(complete, pair_div, c.diverging),
            sum_accept=torch.where(
                active, c.sum_accept + acc1 + torch.where(b_valid, acc2, 0.0), c.sum_accept
            ),
            num_leaves=torch.where(
                active, c.num_leaves + 1 + b_valid.int(), c.num_leaves
            ),
            sub_last=_select(active, new2_p, c.sub_last),
            sub_proposal=_select(active, sub_proposal, c.sub_proposal),
            sub_log_weight=torch.where(active, sub_lw, c.sub_log_weight),
            sub_r_sum=_select(active, sum_b, c.sub_r_sum),
            sub_leaf=torch.where(
                active, torch.where(complete, 0, leaf_b + 1), c.sub_leaf
            ),
            going_right=torch.where(active, going_right, c.going_right),
            iter_idx=c.iter_idx + active.long(),
            ckpts=ckpts,
        )

    def pairs(frame: NutsFrame, c: _NutsCarry, k: int):
        for _ in range(k):
            c = body(frame, c, active(c))
        return c, active(c).any()

    def result(frame: NutsFrame, c: _NutsCarry):
        x = frame.inputs
        num_chains, dim = x.position.shape
        proposal = c.proposal
        new_state = HMCState(
            position=proposal[:, :dim],
            log_prob=proposal[:, 2 * dim],
            grad=proposal[:, dim:2 * dim],
        )
        accept_prob = c.sum_accept / torch.clamp(c.num_leaves.float(), min=1.0)
        info = TransitionInfo(
            accept_prob=accept_prob,
            is_accepted=c.num_leaves > 0,
            is_divergent=c.diverging,
            energy=frame.energy0,
            log_prob=new_state.log_prob,
            num_integration_steps=c.num_leaves,
            tree_depth=c.depth,
            step_size=x.step_size.expand(num_chains),
        )
        return new_state, info

    return NutsParts(root, pairs, result, active, n_slots - 1)


def make_nuts_kernel(
    value_and_grad: Callable[[torch.Tensor], tuple],
    max_tree_depth: int = 10,
    max_delta_energy: float = DELTA_MAX,
    pairs_per_check: int = 1,
    static_schedule: bool = False,
):
    """Build ``(init_fn, step_fn)`` for batched iterative multinomial NUTS.

    ``value_and_grad(Z (C, D)) -> (log_prob (C,), grad (C, D))``.
    ``step_fn(state, tunables, r0, U) -> (state, info, host_syncs)`` runs
    the parts of :func:`make_nuts_parts` eagerly: ``pairs_per_check`` pair
    iterations between host checks, or, with ``static_schedule``, the
    reference's fixed trip count and no check. Every setting gives the same
    bits.
    """
    if pairs_per_check < 1:
        raise ValueError(f"pairs_per_check must be >= 1, got {pairs_per_check}")
    parts = make_nuts_parts(value_and_grad, max_tree_depth, max_delta_energy)

    def init_fn(position: torch.Tensor) -> HMCState:
        log_prob, grad = value_and_grad(position)
        return HMCState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(state: HMCState, tunables: Tunables, r0: torch.Tensor, U: torch.Tensor):
        frame, tree = parts.root(NutsInputs(
            state.position, state.log_prob, state.grad, r0, U, tunables.step_size,
            tunables.inv_mass_diag))
        host_syncs = 0
        if static_schedule:
            tree, _ = parts.pairs(frame, tree, parts.static_pairs)
        else:
            any_active = parts.active(tree).any()
            host_syncs += 1
            while bool(any_active):
                tree, any_active = parts.pairs(frame, tree, pairs_per_check)
                host_syncs += 1
        new_state, info = parts.result(frame, tree)
        return new_state, info, host_syncs

    return init_fn, step_fn
