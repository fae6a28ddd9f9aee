"""The wide GLM pair's two gradient schedules (``launch_plan``'s ``g_walk``).

On the card the wide gradient (Dp > 128, bf16 or int8 X) either writes one
g partial a row split and adds them with ``sum_splits_kernel`` (few
chains), or walks the splits in order in one block a tile, each split into
a fresh accumulator added to a running total (many chains). Here, on the
CPU:

- the plan: its row splits are the same at every C (the bits do not depend
  on C), the depth sweep's shapes at C = 4096 take the walk and write no g
  partials, glm1000_fused's plan at C = 256 is what it was before the walk
  existed, and a call with four chains takes the split schedule;
- the sums: a float32 emulation of both schedules on the same split
  partials gives the same bits, the walk's total starting from -0 (a +0
  start would turn a -0 partial into +0);
- the emulated walk's g against the reference's Pallas kernel in interpret
  mode, at a wide ragged shape with several splits, as
  ``test_torch_glm_wide_int8.py`` holds the plain version: ll 1e-3 nats +
  1e-5 relative, g 1e-4 of max|g| + 1e-5.
The kernels themselves: ``test_torch_cuda_kernels.py``
(``test_wide_gradient_walk_gives_the_split_schedules_bits``).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.ops.pallas.glm import fused_logistic_value_and_grad as j_logistic
from mlx_mcmc_tpu_torch.ops import glm

SMS = 132  # the H100's SMs, as the plan is made on the card
DEPTH_SWEEP = [(5120, 256), (1280, 1024)]  # (N, Dp) of the depth sweep above Dp = 128
WIDE = [torch.bfloat16, torch.int8]


@pytest.mark.parametrize("x_dtype", WIDE)
@pytest.mark.parametrize("n,d_pad", DEPTH_SWEEP)
def test_depth_sweep_walks_without_g_partials_at_4096_chains(n, d_pad, x_dtype):
    plan = glm.launch_plan(n, d_pad, 4096, SMS, x_dtype)
    assert plan["path"] == ("wide_int8" if x_dtype == torch.int8 else "wide")
    assert plan["g_walk"]
    assert glm.g_partial_shape(plan, 4096, d_pad) is None  # no g partial reaches device memory
    # The row splits one block a split takes: 40 or 10 of 128 rows.
    assert plan["g_rows_per_split"] == 128 and plan["g_splits"] == {256: 40, 1024: 10}[d_pad]


@pytest.mark.parametrize("x_dtype", WIDE)
def test_glm1000_fused_plan_is_unchanged(x_dtype):
    # glm1000_fused's shape and chain count: one block a split, the plan's
    # fields those of the split schedule alone, and the g partials as before.
    plan = glm.launch_plan(100_000, 1008, 256, SMS, x_dtype)
    assert plan == {"path": "wide_int8" if x_dtype == torch.int8 else "wide", "splits": 131,
                    "rows_per_split": 768, "g_splits": 16, "g_rows_per_split": 6272,
                    "zb_shape": (256, 1008), "rt_shape": (256, 100_096),
                    "rt_dtype": torch.bfloat16, "g_walk": False}
    assert glm.g_partial_shape(plan, 256, 1000) == (16, 256, 1000)


@pytest.mark.parametrize("x_dtype", WIDE)
@pytest.mark.parametrize("n,d_pad,walks_at_256", [(5120, 256, False), (1280, 1024, True),
                                                  (100_000, 1008, False), (777, 304, False)])
def test_the_walk_depends_on_the_chain_count_and_the_splits_do_not(n, d_pad, walks_at_256,
                                                                   x_dtype):
    keys = ("splits", "rows_per_split", "g_splits", "g_rows_per_split")
    plans = {c: glm.launch_plan(n, d_pad, c, SMS, x_dtype) for c in (1, 4, 256, 4096)}
    assert len({tuple(p[k] for k in keys) for p in plans.values()}) == 1
    # Four chains leave the card nearly idle in a walk: the split schedule,
    # so the smoke's four-chain bits check holds the two schedules together.
    assert not plans[1]["g_walk"] and not plans[4]["g_walk"]
    assert plans[256]["g_walk"] == walks_at_256
    if n < 100_000:
        assert plans[4096]["g_walk"]


def _split_partials(R: torch.Tensor, X: torch.Tensor, plan: dict) -> torch.Tensor:
    """(g_splits, C, Dp) float32 partials of G = R X over the plan's row
    splits, each from its own rows only (the kernels' fresh accumulator)."""
    rows = plan["g_rows_per_split"]
    return torch.stack([R[:, s * rows:(s + 1) * rows] @ X[s * rows:(s + 1) * rows]
                        for s in range(plan["g_splits"])])


def _split_schedule(p: torch.Tensor) -> torch.Tensor:
    """sum_splits_kernel: v = p[0], then v += p[s] in split order."""
    v = p[0].clone()
    for s in range(1, p.shape[0]):
        v = v + p[s]
    return v


def _walk_schedule(p: torch.Tensor, start: float = -0.0) -> torch.Tensor:
    """The walking kernel: a running total from ``start``, each split's
    accumulator added in split order."""
    tot = torch.full_like(p[0], start)
    for s in range(p.shape[0]):
        tot = tot + p[s]
    return tot


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("x_dtype", WIDE)
@pytest.mark.parametrize("n,d,c", [(5120, 256, 64), (1280, 1000, 40), (777, 300, 9)])
def test_walk_sum_gives_the_split_sums_bits(n, d, c, x_dtype):
    rng = np.random.default_rng(n + d)
    X = torch.from_numpy((rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32))
    Xk = glm._quantize_int8(X)[0].float() if x_dtype == torch.int8 else X.bfloat16().float()
    R = torch.from_numpy(rng.standard_normal((c, n)).astype(np.float32)).bfloat16().float()
    plan = glm.launch_plan(n, -(-d // 16) * 16, 4096, SMS, x_dtype)
    assert plan["g_splits"] > 1
    p = _split_partials(R, Xk, plan)
    assert torch.equal(_bits(_walk_schedule(p)), _bits(_split_schedule(p)))


def test_walk_starts_from_negative_zero():
    # Partials with zeros of both signs, infinities and a NaN: -0 + p0 is p0
    # bit for bit, so the walk's total is sum_splits_kernel's; +0 is not.
    p0 = torch.tensor([-0.0, 0.0, -0.0, 1.5, float("inf"), float("nan"), -2.0])
    p1 = torch.tensor([-0.0, -0.0, 0.0, -1.5, 1.0, 1.0, 3.0])
    p = torch.stack([p0, p1])
    assert torch.equal(_bits(_walk_schedule(p[:1])), _bits(p0))
    assert torch.equal(_bits(_walk_schedule(p)), _bits(_split_schedule(p)))
    assert not torch.equal(_bits(_walk_schedule(p[:1], start=0.0)), _bits(p0))


def test_emulated_walk_matches_pallas_interpret():
    # The walk's arithmetic at a wide ragged shape with several splits (N =
    # 260: five splits of 64 rows, the last four rows long), the residual
    # from the plain version's epilogue rounded to bf16 as the value kernel
    # stores it, against the reference's kernel.
    n, d, c = 260, 300, 9
    rng = np.random.default_rng(0)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    beta = rng.standard_normal(d).astype(np.float32)
    y = (rng.random(n) < 1 / (1 + np.exp(-X @ beta))).astype(np.float32)
    Z = (beta + rng.standard_normal((c, d))).astype(np.float32)
    ll_j, g_j = j_logistic(jnp.asarray(X.astype(ml_dtypes.bfloat16)), jnp.asarray(y),
                           jnp.asarray(Z), tile_n=128, interpret=True)
    data = glm.prepare_fused_logistic_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y),
                                           device="cpu")
    Xf = data["Xp"][:, :d].float()
    s = torch.from_numpy(Z).bfloat16().float() @ Xf.T
    term, res = glm._logistic_epilogue(data["yp"], s)
    plan = dict(glm.launch_plan(n, data["Xp"].shape[1], c, SMS), g_walk=True)
    assert plan["g_splits"] == 5
    g_t = _walk_schedule(_split_partials(res.bfloat16().float(), Xf, plan))
    ll_j, g_j = np.asarray(ll_j), np.asarray(g_j)
    np.testing.assert_allclose(term.sum(-1).numpy(), ll_j, rtol=1e-5, atol=1e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-5
