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
- The tree loop is the reference's ``static_schedule`` semantics, a masked
  freeze: ``while active.any(): c = where(active, body(c), c)``. Finished
  chains carry through unchanged, so the draws equal the dynamic
  ``while_loop``'s. Each check of ``active.any()`` is one device-to-host
  sync; ``step_fn`` returns how many it made.
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
    v_first = inv_mass * r_ckpts
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


def make_nuts_kernel(
    value_and_grad: Callable[[torch.Tensor], tuple],
    max_tree_depth: int = 10,
    max_delta_energy: float = DELTA_MAX,
):
    """Build ``(init_fn, step_fn)`` for batched iterative multinomial NUTS.

    ``value_and_grad(Z (C, D)) -> (log_prob (C,), grad (C, D))``.
    ``step_fn(state, tunables, r0, U) -> (state, info, host_syncs)``.
    """
    n_slots = 1 << (max_tree_depth - 1)
    tables = {}

    def init_fn(position: torch.Tensor) -> HMCState:
        log_prob, grad = value_and_grad(position)
        return HMCState(position=position, log_prob=log_prob, grad=grad)

    def step_fn(state: HMCState, tunables: Tunables, r0: torch.Tensor, U: torch.Tensor):
        inv_mass = tunables.inv_mass_diag
        eps = tunables.step_size
        num_chains, dim = state.position.shape
        device = state.position.device
        if device not in tables:
            tables[device] = _slot_tables(max_tree_depth, device)
        write_slots, check_slots = tables[device]
        start = IntegratorState(state.position, r0, state.log_prob, state.grad)
        energy0 = total_energy(start, inv_mass)

        def leaf_energy(new):
            delta = total_energy(new, inv_mass) - energy0
            leaf_div = delta > max_delta_energy
            log_w = -delta  # multinomial log weight, relative to E0
            accept_stat = torch.exp(torch.clamp(-delta, max=0.0))
            return leaf_div, log_w, accept_stat

        def signed_eps(going_right):
            return torch.where(going_right, eps, -eps)[:, None]

        prop = 2 * dim + 1  # proposal columns of a packed point

        # --- peeled root doubling: one leaf, so every loop iteration below
        # processes exactly one even+odd leaf pair.
        u0 = U[:, 0]
        going_right0 = u0[:, 0] < 0.5
        start_p = _pack(start)
        new0 = leapfrog(start, signed_eps(going_right0), inv_mass, value_and_grad)
        new0_p = _pack(new0)
        div0, lw0, acc0 = leaf_energy(new0)
        p_move0 = _nan_to_zero(torch.exp(torch.clamp(lw0, max=0.0)))
        move0 = ~div0 & (u0[:, 3] < p_move0)
        left0 = _select(going_right0, start_p, new0_p)
        right0 = _select(going_right0, new0_p, start_p)
        r_sum0 = r0 + new0.r
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
            sub_r_sum=torch.zeros_like(r0),
            sub_leaf=torch.zeros((num_chains,), **i64),
            going_right=torch.zeros((num_chains,), dtype=torch.bool, device=device),
            iter_idx=torch.ones((num_chains,), **i64),
            ckpts=r0.new_zeros((num_chains, max_tree_depth, 2 * dim)),
        )
        rows = torch.arange(num_chains, device=device)

        def body(c: _NutsCarry, active: torch.Tensor) -> _NutsCarry:
            """One leaf pair for every chain; chains not ``active`` keep
            their carry (the masked freeze). Fields that change only when a
            subtree completes are frozen through ``complete``."""
            starting = c.sub_leaf == 0  # first pair of a new subtree?
            # Frozen chains may sit past the table's end; their result is
            # discarded, so the clamp only keeps the gather legal.
            u4 = U[rows, torch.clamp(c.iter_idx, max=n_slots - 1)]
            going_right = torch.where(starting, u4[:, 0] < 0.5, c.going_right)
            eps_signed = signed_eps(going_right)

            # Integrate from the tree's outgoing edge when starting a
            # subtree, else from the last integration point.
            base = _select(starting, _select(going_right, c.right, c.left), c.sub_last)
            new1 = leapfrog(_unpack(base, dim), eps_signed, inv_mass, value_and_grad)  # leaf A
            div1, lw1, acc1 = leaf_energy(new1)
            new1_p = _pack(new1)
            new2 = leapfrog(new1, eps_signed, inv_mass, value_and_grad)  # leaf B
            div2, lw2, acc2 = leaf_energy(new2)
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

        tree = carry0
        host_syncs = 0
        while True:
            active = ~tree.turning & ~tree.diverging & (tree.depth < max_tree_depth)
            host_syncs += 1
            if not bool(active.any()):
                break
            tree = body(tree, active)

        proposal = tree.proposal
        new_state = HMCState(
            position=proposal[:, :dim],
            log_prob=proposal[:, 2 * dim],
            grad=proposal[:, dim:2 * dim],
        )
        accept_prob = tree.sum_accept / torch.clamp(tree.num_leaves.float(), min=1.0)
        info = TransitionInfo(
            accept_prob=accept_prob,
            is_accepted=tree.num_leaves > 0,
            is_divergent=tree.diverging,
            energy=energy0,
            log_prob=new_state.log_prob,
            num_integration_steps=tree.num_leaves,
            tree_depth=tree.depth,
            step_size=eps.expand(num_chains),
        )
        return new_state, info, host_syncs

    return init_fn, step_fn
