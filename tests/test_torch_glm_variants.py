"""Port parity: the microbenchmark variants of K1's body (``ops/glm_variants.py``)
against the reference's Pallas variants, and the two benchmark entry points'
operands against the reference's scripts.

Each plain version is held to its reference kernel run through
``_fused_padded_call(..., interpret=True, kernel_fn=...)`` on the CPU, on the
reference's own operands (``benchmarks/flagship_decomposition.make_operands``)
at a small shape: N = 512, Dp = 128, C = 256, tile_n = 128, c_tile = 128 (and
floor at Dp = 256). Both sides take the same bf16 X and bf16 Z, accumulate in
float32 and round the residual to bf16; only the summation order and the
tanh/log/exp implementations differ. Tolerances, as ``chip_smoke.py`` holds
the kernels: ll per chain within 1e-3 + 1e-5 |ll|, g within 1e-4 of max|g| +
1e-5 and two residual flips: a last-bit change of s, or of exp (XLA's CPU
exp is not correctly rounded), flips the bf16 rounding of a residual now
and then, which moves g by max|x| times a bf16 ulp of the residual
(``glm_variants.residual_flip``); mm1_pair's ll within 1e-4 relative, except chains where one bf16(ll) rounds
the other way (``glm_variants.mm1_pair_agreement``: at most 0.5% of them, and
at most 0.1% within one float32 ulp of a bf16 boundary; none at this size).
The kernels themselves: ``test_torch_cuda_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import flagship_decomposition as ref_fd
from benchmarks import glm_kernel_variants as ref_gkv
from mlx_mcmc_tpu.ops.pallas.glm import _fused_padded_call
from mlx_mcmc_tpu_torch.benchmarks import flagship_decomposition as fd
from mlx_mcmc_tpu_torch.benchmarks import glm_kernel_variants as gkv
from mlx_mcmc_tpu_torch.ops import glm_variants

N, DP, C, TILE, C_TILE = 512, 128, 256, 128, 128

REFERENCE = {
    "floor": ref_gkv.floor_kernel,
    "mm1_sum": ref_fd.mm1_sum_kernel,
    "floor_nosum": ref_fd.floor_nosum_kernel,
    "tanh_y": ref_gkv.tanh_y_kernel,
    "tanh_hoist": ref_gkv.tanh_hoist_kernel,
    "exp_hoist": ref_gkv.exp_hoist_kernel,
    "split2": ref_fd.split2_kernel,
    "mm1_pair": ref_fd.mm1_pair_kernel,
}


def _operands(n, d_pad, c, seed=0):
    """The reference's operands and the port's of the same call."""
    ref = ref_fd.make_operands(n, d_pad, c, seed=seed)
    return ref, fd.make_operands(n, d_pad, c, seed=seed, device="cpu")


def _reference(kernel_fn, ref):
    Xp, yp, Bt = ref
    ll, g = _fused_padded_call(Xp, yp, Bt, TILE, True, kernel_fn=kernel_fn, c_tile=C_TILE)
    return np.asarray(ll)[0], np.asarray(g).T


def _close(ll_t, g_t, ll_j, g_j, flip):
    np.testing.assert_allclose(ll_t.numpy(), ll_j, rtol=1e-5, atol=1e-3)
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-4 * np.abs(g_j).max() + 1e-5 + 2 * flip


def test_operands_are_the_reference_ones():
    for n, d_pad, c, seed in ((N, DP, C, 0), (1280, 1024, 64, 1), (10240, 128, 4096, 0)):
        (Xp_j, yp_j, Bt_j), (Xp, yp, Z) = _operands(n, d_pad, c, seed)
        assert Xp.dtype == torch.bfloat16 and Xp.shape == (n, d_pad) and Z.shape == (c, d_pad)
        assert np.array_equal(np.asarray(Xp_j.astype(jnp.float32)), Xp.float().numpy())
        assert np.array_equal(np.asarray(yp_j)[:, 0], yp.numpy())
        assert np.array_equal(np.asarray(Bt_j.astype(jnp.float32)).T, Z.numpy())


def test_glm_kernel_variants_operands_are_main_s():
    # The reference's main(), up to its padding, line for line.
    rng = np.random.default_rng(0)
    X = rng.normal(size=(ref_gkv.N, ref_gkv.D)).astype(np.float32) / np.sqrt(ref_gkv.D)
    beta_true = rng.normal(size=(ref_gkv.D,)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(X @ beta_true)))
    y = (rng.random(ref_gkv.N) < p).astype(np.float32)
    Z = rng.normal(size=(ref_gkv.C, ref_gkv.D)).astype(np.float32) * 0.5
    Xb = jnp.asarray(X, jnp.bfloat16)
    Xp_j = jnp.zeros((ref_gkv.N_PAD, ref_gkv.D_PAD), jnp.bfloat16).at[:ref_gkv.N, :ref_gkv.D].set(Xb)
    yp_j = jnp.zeros((ref_gkv.N_PAD, 1), jnp.float32).at[:ref_gkv.N, 0].set(y)
    Bt_j = jnp.zeros((ref_gkv.D_PAD, ref_gkv.C_PAD), jnp.bfloat16).at[:ref_gkv.D, :ref_gkv.C].set(
        jnp.asarray(Z, jnp.bfloat16).T)

    Xp, yp, Zp, y_t = gkv.make_operands(device="cpu")
    assert (gkv.N, gkv.D, gkv.C, gkv.N_PAD, gkv.D_PAD) == (
        ref_gkv.N, ref_gkv.D, ref_gkv.C, ref_gkv.N_PAD, ref_gkv.D_PAD)
    assert np.array_equal(np.asarray(Xp_j.astype(jnp.float32)), Xp.float().numpy())
    assert np.array_equal(np.asarray(yp_j)[:, 0], yp.numpy())
    assert np.array_equal(np.asarray(Bt_j.astype(jnp.float32)).T, Zp.numpy())
    assert np.array_equal(y, y_t.numpy())


def test_oracle_matches_the_reference_oracle():
    rng = np.random.default_rng(3)
    X = (rng.normal(size=(300, 20)) / np.sqrt(20)).astype(np.float32)
    y = (rng.random(300) < 0.5).astype(np.float32)
    Z = rng.normal(size=(7, 20)).astype(np.float32)
    ll_j, g_j = ref_gkv.oracle(jnp.asarray(X), jnp.asarray(y), jnp.asarray(Z))
    ll_t, g_t = gkv.oracle(torch.from_numpy(X), torch.from_numpy(y), torch.from_numpy(Z))
    np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", [n for n in glm_variants.VARIANTS if n != "mm1_pair"])
def test_plain_version_matches_pallas_interpret(name):
    ref, (Xp, yp, Z) = _operands(N, DP, C)
    ll_j, g_j = _reference(REFERENCE[name], ref)
    before = glm_variants.launch_counts()
    ll_t, g_t = glm_variants.run(name, Xp, yp, Z)
    assert glm_variants.launch_counts() == before  # CPU tensors: the plain version
    assert ll_t.shape == (C,) and g_t.shape == (C, DP)
    _close(ll_t, g_t, ll_j, g_j, glm_variants.residual_flip(name, Xp, Z))
    if name == "mm1_sum":
        assert not g_t.any()
    if name == "floor_nosum":
        assert not ll_t.any()


def test_floor_of_both_reference_scripts_is_one_function():
    ref, _ = _operands(N, DP, C)
    for a, b in zip(_reference(ref_gkv.floor_kernel, ref), _reference(ref_fd.floor_kernel, ref)):
        assert np.array_equal(a, b)


def test_floor_plain_version_matches_pallas_interpret_deeper():
    # The depth sweep's D_PAD = 256 (the wide pair on the card).
    ref, (Xp, yp, Z) = _operands(N, 256, C, seed=1)
    ll_j, g_j = _reference(REFERENCE["floor"], ref)
    _close(*glm_variants.run("floor", Xp, yp, Z), ll_j, g_j, glm_variants.residual_flip("floor", Xp, Z))


def test_mm1_pair_plain_version_matches_pallas_interpret():
    ref, (Xp, yp, Z) = _operands(N, DP, C)
    ll_j, g_j = _reference(REFERENCE["mm1_pair"], ref)
    ll_t, g_t = glm_variants.run("mm1_pair", Xp, yp, Z, tile_rows=TILE)
    assert not g_t.any() and not g_j.any()
    agree = glm_variants.mm1_pair_agreement(Xp, Z, torch.tensor(ll_j), TILE)
    assert len(agree["unexplained"]) == 0 and len(agree["boundary"]) <= 1e-3 * C
    assert len(agree["flipped"]) <= 5e-3 * C and agree["max_rel_err"] <= 1e-4
    assert np.abs(ll_t.numpy() - ll_j).max() <= 1e-4 * np.abs(ll_j).max()
    # The recurrence grows ll by ~tile_n^0.5 per tile: it is not the floor's sum.
    assert np.abs(ll_j).max() > 100 * np.abs(glm_variants.run("mm1_sum", Xp, yp, Z)[0].numpy()).max()


def test_mm1_pair_agreement_finds_boundary_chains_and_flips():
    # After its one tile, chain 0's running ll is 1 + 2^-8, halfway between
    # two bf16 values; chain 1's is 2^-20 (8 float32 ulps) past it. Row 1
    # reads column 3, where Z is 0: its second product is bf16(ll) itself.
    Xp = torch.zeros((64, 16), dtype=torch.bfloat16)
    Xp[0, :3] = torch.tensor([1.0, 2**-8, 2**-20])
    Xp[1, 3] = 1.0
    Z = torch.zeros((2, 16))
    Z[0, :2] = 1.0
    Z[1, :3] = 1.0
    ll = glm_variants.mm1_pair_reference(Xp, None, Z, tile_rows=64)[0]
    agree = glm_variants.mm1_pair_agreement(Xp, Z, ll, 64)
    assert agree["boundary"].tolist() == [0] and agree["max_rel_err"] == 0.0
    assert agree["flipped"].numel() == 0 and agree["unexplained"].numel() == 0
    # chain 1 with its bf16(ll) rounded down instead of up, as another
    # summation order 8 ulps lower could have: explained as one flip.
    other = glm_variants._mm1_pair(Xp, Z, 64, flip_tile=0)[0]
    agree = glm_variants.mm1_pair_agreement(Xp, Z, torch.stack([ll[0], other[1]]), 64)
    assert agree["flipped"].tolist() == [1] and agree["margins_of_flipped"].tolist() == [8]
    agree = glm_variants.mm1_pair_agreement(Xp, Z, ll * torch.tensor([1.0, 1.01]), 64)
    assert agree["unexplained"].tolist() == [1]


@pytest.mark.parametrize("name", list(glm_variants.VARIANTS) + ["current"])
def test_wrappers_refuse_cpu_tensors_and_other_types(name):
    _, (Xp, yp, Z) = _operands(64, 16, 4)
    kernel = glm_variants.current_cuda if name == "current" else glm_variants.VARIANTS[name][0]
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernel(Xp, yp, Z)
    assert kernel.launches == 0
