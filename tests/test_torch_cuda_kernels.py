"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a GPU. This file imports neither JAX nor the reference
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda

Tolerances as in ``chip_smoke.py``:
- GLM kernels (K1 logistic, K2 linear, K4 hoisted; bf16 or int8 X, one-pass
  and wide paths; int8 X is widened to bf16 in shared memory, exactly):
  ll within 0.05 nats (f32 sums over N rows in another
  order; sums that grow with N, K2's squares, K4's softplus and every ll at
  N = 100K, add 1e-6 relative: one f32 ulp of |ll| ~ 7e4 is 0.0078 nats),
  g within 1e-2 of max|g| + 1e-3 (a last-bit change of s can flip the bf16
  rounding of single residuals). The wide kernels at N = 100K hold g
  to 1e-4 of max|g| + 1e-3: max|g| grows with N there while a flip does not,
  and 1e-2 would let a 64-row chunk of the gradient kernel's split schedule
  be dropped or taken twice (measured error ~1e-5 of max|g| at glm1000).
- GLM kernels on f32 X (nothing rounded; 3xTF32 products): ll as above, g
  within 1e-4 of max|g| + 1e-4 (summation order and the split's ~2^-22 per
  product move g by a few f32 ulps of its terms). Against ll and g computed
  in float64 from the same X, y and Z (``glm.vag_float64``), the kernels'
  max error is at most twice the plain float32 version's; at the one-row
  and one-chain shapes, where both errors are a single rounding or two and
  their ratio is noise, plus two f32 ulps of the largest value.
- Every kernel is also held to exact equality where the design promises
  it: two calls on the same inputs give the same bits, and chains 0-3 give
  the same bits in a call with 4 chains as in one with 4096 (glm100's shape,
  every X type and path; the wide bf16 path at 256) or 512 (K3): no split
  schedule depends on C.
- Poisson kernel (K3), all float32: ll within 0.05 nats + 1e-6 relative,
  r_theta and g_beta within 1e-4 of their max + 1e-3 (FMA contraction and
  summation order move single rates by an ulp).
- Philox: integer words and uniforms bit for bit; normals within 2e-6
  (``logf``/``sincosf`` against torch's ``log``/``cos``/``sin``).
- The variants of K1's body (``ops/glm_variants.py``, accurate epilogues):
  ll per chain within 1e-3 + 1e-5 |ll|, g within 1e-4 of max|g| + 1e-5 and
  two residual flips (``glm_variants.residual_flip``); mm1_pair's ll within
  1e-4 relative except chains with one bf16(ll) rounded the other way
  (``glm_variants.mm1_pair_agreement``; at most 0.5% of them, and at most
  0.1% within one f32 ulp of a bf16 boundary); two calls give the same
  bits, and tanh_y's, tanh_hoist's, exp_hoist's and mm1_pair's chains 0 to
  k - 1 give the same bits in a call with k = 4 or 129 chains as in the
  full call; mm1_pair also at every cluster size.
"""

import functools

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch.ops import glm, glm_variants, poisson
from mlx_mcmc_tpu_torch.ops import random as prng


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _glm_case(n, d, c, family, seed=2, quantize=None, x_dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    if family == "logistic":
        y = (rng.random(n) < 0.5).astype(np.float32)
        data = glm.prepare_fused_logistic_data(torch.from_numpy(X).to(x_dtype), torch.from_numpy(y),
                                               quantize=quantize)
    else:
        y = (X @ rng.standard_normal(d) + rng.standard_normal(n)).astype(np.float32)
        data = glm.prepare_fused_linear_data(torch.from_numpy(X).to(x_dtype), torch.from_numpy(y))
    Z = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).cuda()
    if quantize:  # the kernel's operand is the scaled Z
        Z = Z * data["col_scale"]
    return data, Z


_GLM_SHAPES = [(10_000, 100, 4096), (777, 37, 1000), (1, 5, 65), (130, 128, 64),
               (2000, 1000, 256), (300, 130, 70), (129, 144, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("n,d,c", _GLM_SHAPES)
def test_glm_kernel_matches_plain_version(n, d, c, quantize):
    _need_gpu()
    data, Z = _glm_case(n, d, c, "logistic", quantize=quantize)
    assert data["Xp"].dtype == (torch.int8 if quantize else torch.bfloat16)
    before = glm.fused_logistic_vag_cuda.launches
    ll_k, g_k = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], Z)
    assert glm.fused_logistic_vag_cuda.launches == before + 1
    ll_p, g_p = glm.fused_logistic_vag_reference(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    assert float((ll_k - ll_p).abs().max()) <= 0.05
    assert float((g_k - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
@pytest.mark.parametrize("n,d,c", _GLM_SHAPES)
def test_hoisted_kernel_matches_plain_version(n, d, c, quantize):
    _need_gpu()
    data, Z = _glm_case(n, d, c, "logistic", quantize=quantize)
    before = glm.fused_hoisted_vag_cuda.launches
    sp_k, gs_k = glm.fused_hoisted_value_and_grad(data["Xp"], Z)
    assert glm.fused_hoisted_vag_cuda.launches == before + 1
    sp_p, gs_p = glm.fused_hoisted_vag_reference(data["Xp"], Z)
    torch.cuda.synchronize()
    assert float((sp_k - sp_p).abs().max()) <= 0.05 + 1e-6 * float(sp_p.abs().max())
    assert float((gs_k - gs_p).abs().max()) <= 1e-2 * float(gs_p.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c", [(10_000, 100, 4096), (777, 37, 1000), (130, 128, 64),
                                   (2000, 1000, 256), (300, 130, 70)])
def test_linear_kernel_matches_plain_version(n, d, c):
    _need_gpu()
    data, Z = _glm_case(n, d, c, "linear")
    before = glm.fused_linear_vag_cuda.launches
    ll_k, g_k = glm.fused_linear_value_and_grad(data["Xp"], data["yp"], Z)
    assert glm.fused_linear_vag_cuda.launches == before + 1
    ll_p, g_p = glm.fused_linear_vag_reference(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    assert float((ll_k - ll_p).abs().max()) <= 0.05 + 1e-6 * float(ll_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max()) + 1e-3


def _vag(family):
    """(kernel, plain version) of one GLM family, as f(Xp, y, Z) (the
    kernel f(Xp, y, Z, XpT) for f32 X)."""
    if family == "hoisted":
        return (lambda X, y, Z, XpT=None: glm.fused_hoisted_vag_cuda(X, Z, XpT),
                lambda X, y, Z: glm.fused_hoisted_vag_reference(X, Z))
    return {"logistic": (glm.fused_logistic_vag_cuda, glm.fused_logistic_vag_reference),
            "linear": (glm.fused_linear_vag_cuda, glm.fused_linear_vag_reference)}[family]


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "linear", "hoisted"])
@pytest.mark.parametrize("n,d,c", [(10_000, 100, 4096), (777, 300, 70), (1, 5, 65), (129, 144, 1),
                                   (2000, 1000, 256)])
def test_f32_kernels_match_plain_version(n, d, c, family):
    _need_gpu()
    data, Z = _glm_case(n, d, c, "linear" if family == "linear" else "logistic",
                        x_dtype=torch.float32)
    assert data["Xp"].dtype == torch.float32
    kernel, plain = _vag(family)
    ll_k, g_k = kernel(data["Xp"], data["yp"], Z, data["XpT"])
    ll_p, g_p = plain(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    assert float((ll_k - ll_p).abs().max()) <= 0.05 + 1e-6 * float(ll_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max()) + 1e-4
    ll_d, g_d = glm.vag_float64(family, data["Xp"], data["yp"], Z)
    single = n == 1 or c == 1  # both errors a rounding or two: the ratio is noise
    for k, p, ref in ((ll_k, ll_p, ll_d), (g_k, g_p, g_d)):
        err_k, err_p = float((k.double() - ref).abs().max()), float((p.double() - ref).abs().max())
        slack = 2 * 2.0**-23 * float(ref.abs().max()) if single else 0.0
        assert err_k <= 2 * err_p + slack, (err_k, err_p)


@functools.lru_cache(maxsize=2)
def _wide_data(n, d):
    """bf16 X (n, d) with logistic and linear outcomes, made on the card
    from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    x = (torch.randn(n, d, generator=gen, device="cuda") / d**0.5).bfloat16()
    y_log = (torch.rand(n, generator=gen, device="cuda") < 0.5).float()
    y_lin = x.float() @ torch.randn(d, generator=gen, device="cuda") + torch.randn(
        n, generator=gen, device="cuda")
    return (glm.prepare_fused_logistic_data(x, y_log), glm.prepare_fused_linear_data(x, y_lin))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "linear", "hoisted"])
@pytest.mark.parametrize("c", [1, 70, 256, 300])
@pytest.mark.parametrize("d", [130, 300, 1000])  # Dp = 144, 304, 1008
@pytest.mark.parametrize("n", [777, 100_000])
def test_wide_bf16_kernels_match_plain_version(n, d, c, family):
    _need_gpu()
    log_data, lin_data = _wide_data(n, d)
    data = lin_data if family == "linear" else log_data
    assert glm.launch_plan(n, data["Xp"].shape[1], c, 132)["path"] == "wide"
    Z = torch.randn(c, d, generator=torch.Generator(device="cuda").manual_seed(c), device="cuda")
    kernel, plain = _vag(family)
    ll_k, g_k = kernel(data["Xp"], data["yp"], Z)
    ll_p, g_p = plain(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    g_rel = 1e-4 if n == 100_000 else 1e-2
    assert float((ll_k - ll_p).abs().max()) <= 0.05 + 1e-6 * float(ll_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= g_rel * float(g_p.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(777, 300), (100_000, 1000)])
def test_wide_bf16_kernels_are_reproducible_and_batch_invariant(n, d):
    _need_gpu()
    data, _ = _wide_data(n, d)
    Z = torch.randn(256, d, generator=torch.Generator(device="cuda").manual_seed(7), device="cuda")
    a = glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z)
    b = glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z)
    four = glm.fused_logistic_vag_cuda(data["Xp"], data["yp"], Z[:4].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0][:4], four[0]) and torch.equal(a[1][:4], four[1])


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["glm_fused_logistic", "glm_fused_linear", "glm_fused_hoisted"])
@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n,d,c", [(1280, 1024, 4096), (5120, 256, 700), (777, 300, 300),
                                   (100_000, 1000, 130), (129, 144, 1)])
def test_wide_gradient_walk_gives_the_split_schedules_bits(n, d, c, x_dtype, entry):
    # The wide gradient's two schedules (launch_plan's g_walk) on the same
    # inputs: one block a split with partials summed by sum_splits_kernel,
    # and one block a tile walking the splits into a running total. Same
    # bits, and near the plain version.
    _need_gpu()
    if entry == "glm_fused_linear" and x_dtype == torch.int8:
        pytest.skip("the linear kernel takes no int8 X, as the reference")
    log_data, lin_data = _wide_data(n, d)
    data = lin_data if entry == "glm_fused_linear" else log_data
    if x_dtype == torch.int8:
        data = glm.prepare_fused_logistic_data(data["Xp"][:, :d], data["yp"], quantize="int8")
    Xp, y = data["Xp"], None if entry == "glm_fused_hoisted" else data["yp"]
    Z = torch.randn(c, d, generator=torch.Generator(device="cuda").manual_seed(c), device="cuda")
    if x_dtype == torch.int8:  # the kernel's operand is the scaled Z
        Z = Z * data["col_scale"]
    plan = glm.launch_plan(n, Xp.shape[1], c, glm.sm_count(0), Xp.dtype)
    walk = glm._launch(entry, Xp, y, Z, dict(plan, g_walk=True))
    split = glm._launch(entry, Xp, y, Z, dict(plan, g_walk=False))
    family = {"glm_fused_logistic": "logistic", "glm_fused_linear": "linear"}.get(entry, "hoisted")
    ll_p, g_p = _vag(family)[1](Xp, data["yp"], Z)
    torch.cuda.synchronize()
    assert torch.equal(walk[0], split[0]) and torch.equal(walk[1], split[1])
    g_rel = 1e-4 if n == 100_000 else 1e-2
    assert float((walk[0] - ll_p).abs().max()) <= 0.05 + 1e-6 * float(ll_p.abs().max())
    assert float((walk[1] - g_p).abs().max()) <= g_rel * float(g_p.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "linear", "hoisted"])
@pytest.mark.parametrize("n,d,c", [(10_000, 100, 4096), (777, 128, 70), (1, 16, 1), (4097, 112, 300),
                                   (130, 5, 129), (64, 33, 128)])
def test_onepass_bf16_kernel_matches_plain_version(n, d, c, family):
    # The TMA + wgmma one-pass kernel (bf16, Dp <= 128): Dp = 16 to 128,
    # ragged N (one row, a partial last tile) and C (one chain, a partial
    # chain tile).
    _need_gpu()
    data, Z = _glm_case(n, d, c, "linear" if family == "linear" else "logistic")
    assert glm.launch_plan(n, data["Xp"].shape[1], c, 132)["path"] == "narrow"
    kernel, plain = _vag(family)
    ll_k, g_k = kernel(data["Xp"], data["yp"], Z)
    ll_p, g_p = plain(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    ll_rel = 0.0 if family == "logistic" else 1e-6
    assert float((ll_k - ll_p).abs().max()) <= 0.05 + ll_rel * float(ll_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "hoisted"])
@pytest.mark.parametrize("n,d,c", [(10_000, 100, 4096), (100_000, 1000, 256), (777, 300, 70),
                                   (4097, 112, 300), (1000, 48, 129), (1000, 300, 33)])
def test_int8_kernels_match_plain_version_and_keep_their_bits(n, d, c, family):
    # int8 X through the TMA + wgmma kernels with the widening stage: glm100
    # (one pass), glm1000 (the wide pair) and ragged shapes whose N is no
    # multiple of a stage's rows (one pass: 64; wide: 128 and 64), so the
    # widened tail rows must be masked; Dp = 48 widens one 64-column box.
    # Then two calls give the same bits, and chains 0-3 the same bits at C = 4.
    _need_gpu()
    if n == 100_000:
        log_data, _ = _wide_data(n, d)
        data = glm.prepare_fused_logistic_data(log_data["Xp"][:, :d], log_data["yp"], quantize="int8")
        Z = torch.randn(c, d, generator=torch.Generator(device="cuda").manual_seed(c),
                        device="cuda") * data["col_scale"]
    else:
        data, Z = _glm_case(n, d, c, "logistic", quantize="int8")
    assert data["Xp"].dtype == torch.int8
    path = glm.launch_plan(n, data["Xp"].shape[1], c, 132, torch.int8)["path"]
    assert path == ("narrow" if d <= 128 else "wide_int8")
    kernel, plain = _vag(family)
    ll_k, g_k = kernel(data["Xp"], data["yp"], Z)
    ll_p, g_p = plain(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    ll_rel = 0.0 if family == "logistic" and n < 100_000 else 1e-6
    g_rel = 1e-4 if n == 100_000 else 1e-2  # as the wide bf16 kernels at N = 100K
    assert float((ll_k - ll_p).abs().max()) <= 0.05 + ll_rel * float(ll_p.abs().max())
    assert float((g_k - g_p).abs().max()) <= g_rel * float(g_p.abs().max()) + 1e-3
    b = kernel(data["Xp"], data["yp"], Z)
    four = kernel(data["Xp"], data["yp"], Z[:4].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(ll_k, b[0]) and torch.equal(g_k, b[1])
    assert torch.equal(ll_k[:4], four[0]) and torch.equal(g_k[:4], four[1])


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["logistic", "linear", "hoisted"])
@pytest.mark.parametrize("x_dtype,quantize,d", [(torch.bfloat16, None, 100), (torch.bfloat16, "int8", 100),
                                                (torch.float32, None, 100), (torch.bfloat16, "int8", 300)])
def test_glm_kernels_are_reproducible_and_batch_invariant(x_dtype, quantize, d, family):
    # glm100's shape on every other path (one-pass bf16 and int8, f32, wide
    # int8): two calls give the same bits, and chains 0-3 give the same bits
    # at C = 4 as at C = 4096.
    _need_gpu()
    if family == "linear" and quantize:
        pytest.skip("the linear kernel takes no int8 X, as the reference")
    data, Z = _glm_case(10_000, d, 4096, "linear" if family == "linear" else "logistic",
                        quantize=quantize, x_dtype=x_dtype)
    kernel, _ = _vag(family)
    xt = data.get("XpT")
    a = kernel(data["Xp"], data["yp"], Z, xt)
    b = kernel(data["Xp"], data["yp"], Z, xt)
    four = kernel(data["Xp"], data["yp"], Z[:4].contiguous(), xt)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[0][:4], four[0]) and torch.equal(a[1][:4], four[1])


@pytest.mark.cuda
def test_glm_kernel_refuses_what_it_does_not_take():
    _need_gpu()
    Xp = torch.zeros(10, 16, dtype=torch.bfloat16, device="cuda")
    y = torch.zeros(10, device="cuda")
    Z = torch.zeros(3, 16, device="cuda")
    hoisted = lambda X, y, Z, XpT=None: glm.fused_hoisted_vag_cuda(X, Z, XpT)  # noqa: E731
    for launch in (glm.fused_logistic_vag_cuda, glm.fused_linear_vag_cuda, hoisted):
        launch(Xp.float(), y, Z, glm.transpose_f32(Xp.float()))  # f32 with its X^T: taken
        with pytest.raises(ValueError, match="XpT"):
            launch(Xp.float(), y, Z)
        with pytest.raises(ValueError, match="XpT"):
            launch(Xp.float(), y, Z, Xp.float().T.contiguous())  # rows not padded to 4
        for dtype in (torch.float16, torch.float64):
            with pytest.raises(ValueError, match="bf16, int8 or f32"):
                launch(Xp.to(dtype), y, Z)
        with pytest.raises(ValueError, match="Dp"):
            launch(torch.zeros(10, 24, dtype=torch.bfloat16, device="cuda"), y, Z)
        with pytest.raises(ValueError, match="contiguous"):
            launch(Xp, y, torch.zeros(16, 3, device="cuda").T)
        launch(torch.zeros(10, 144, dtype=torch.bfloat16, device="cuda"), y, Z)  # wide: taken
    with pytest.raises(ValueError, match="int8"):
        glm.fused_linear_vag_cuda(Xp.to(torch.int8), y, Z)


def _poisson_case(c, g, n, k, seed=3):
    rng = np.random.default_rng(seed)
    X = (0.5 * rng.standard_normal((g, n, k))).astype(np.float32)
    beta_true = (0.3 * rng.standard_normal(k)).astype(np.float32)
    theta_true = (1.0 + 0.5 * rng.standard_normal(g)).astype(np.float32)
    y = rng.poisson(np.exp(theta_true[:, None] + X @ beta_true)).astype(np.float32)
    data = poisson.prepare_fused_poisson_data(torch.from_numpy(y), torch.from_numpy(X))
    theta = torch.from_numpy((theta_true + 0.1 * rng.standard_normal((c, g))).astype(np.float32)).cuda()
    beta = torch.from_numpy((beta_true + 0.1 * rng.standard_normal((c, k))).astype(np.float32)).cuda()
    return data, theta, beta


@pytest.mark.cuda
@pytest.mark.parametrize("c,g,n,k", [(512, 1000, 100, 4), (300, 37, 61, 3), (1, 1, 300, 8),
                                     (70, 5, 2500, 1), (257, 1001, 13, 8), (4, 3, 1025, 4),
                                     (513, 4000, 9, 1)])
def test_poisson_kernel_matches_plain_version(c, g, n, k):
    _need_gpu()
    data, theta, beta = _poisson_case(c, g, n, k)
    args = (data["X"], data["y"], data["shat"], data["lamhat"], theta, beta)
    before = poisson.fused_poisson_vag_cuda.launches
    out_k = poisson.fused_poisson_value_and_grad(*args)
    assert poisson.fused_poisson_vag_cuda.launches == before + 1
    out_p = poisson.fused_poisson_vag_reference(*args)
    torch.cuda.synchronize()
    ll_k, rt_k, gb_k = out_k
    ll_p, rt_p, gb_p = out_p
    assert float((ll_k - ll_p).abs().max()) <= 0.05 + 1e-6 * float(ll_p.abs().max())
    for k_out, p_out in ((rt_k, rt_p), (gb_k, gb_p)):
        assert float((k_out - p_out).abs().max()) <= 1e-4 * float(p_out.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,k", [(1000, 100, 4), (37, 61, 3), (3, 1025, 8)])
def test_poisson_kernel_is_reproducible_and_batch_invariant(g, n, k):
    _need_gpu()
    data, theta, beta = _poisson_case(512, g, n, k)
    args = (data["X"], data["y"], data["shat"], data["lamhat"])
    a = poisson.fused_poisson_vag_cuda(*args, theta, beta)
    b = poisson.fused_poisson_vag_cuda(*args, theta, beta)
    four = poisson.fused_poisson_vag_cuda(*args, theta[:4].contiguous(), beta[:4].contiguous())
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x[:4], y) for x, y in zip(a, four))


@pytest.mark.cuda
def test_poisson_kernel_refuses_what_it_does_not_take():
    _need_gpu()
    data, theta, beta = _poisson_case(4, 3, 5, 2)
    args = [data["X"], data["y"], data["shat"], data["lamhat"], theta, beta]
    with pytest.raises(ValueError, match="float32"):
        poisson.fused_poisson_vag_cuda(*args[:4], theta.double(), beta)
    with pytest.raises(ValueError, match="contiguous"):
        poisson.fused_poisson_vag_cuda(*args[:5], torch.zeros(2, 4, device="cuda").T)
    with pytest.raises(ValueError, match="shape"):
        poisson.fused_poisson_vag_cuda(*args[:4], theta[:, :2].contiguous(), beta)
    wide = torch.zeros(3, 5, 9, device="cuda")
    with pytest.raises(ValueError, match="K"):
        poisson.fused_poisson_vag_cuda(wide, *args[1:4], theta, torch.zeros(4, 9, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("c,dim,n_slots", [(4096, 100, 32), (512, 1006, 128), (37, 7, 1)])
def test_philox_kernel_matches_plain_version(c, dim, n_slots):
    _need_gpu()
    chains = torch.arange(5, 5 + c, device="cuda")
    before = prng.step_draws_cuda.launches
    z_k, u_k = prng.step_draws(123456789012345, chains, 17, dim, n_slots)
    assert prng.step_draws_cuda.launches == before + 1
    z_p, u_p = prng.step_draws_reference(123456789012345, chains, 17, dim, n_slots)
    assert torch.equal(u_k, u_p)
    assert float((z_k - z_p).abs().max()) <= 2e-6
    for stream in (prng.STREAM_NORMAL, prng.STREAM_UNIFORM):
        w_k = prng.words_cuda(2**63 + 11, chains, 0x7FFFFFFF, 3, stream)
        assert torch.equal(w_k, prng.words(2**63 + 11, chains, 0x7FFFFFFF, 3, stream))


@pytest.mark.cuda
def test_philox_kernel_known_answers_and_arguments():
    _need_gpu()
    # Random123's vector: counter (0, 0, 0, 0), key (0, 0).
    w = prng.words_cuda(0, torch.zeros(1, dtype=torch.int64, device="cuda"), 0, 1, 0)
    assert w.flatten().tolist() == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    with pytest.raises(ValueError, match="int64"):
        prng.step_draws_cuda(0, torch.arange(4, device="cuda").int(), 0, 3, 2)
    with pytest.raises(ValueError, match="CUDA"):
        prng.step_draws_cuda(0, torch.arange(4), 0, 3, 2)
    _, u = prng.step_draws_cuda(0, torch.arange(4, device="cuda"), 0, 3, 0)
    assert u.shape == (4, 0, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [3, 100, 1006])
def test_row_sum_is_batch_invariant(d):
    # The NUTS loop's and the vags' row sums: chains 0-3 of a 4-row batch
    # give the bits of a 512-row batch (torch's own sum need not).
    _need_gpu()
    from mlx_mcmc_tpu_torch.ops.math import row_sum

    x = torch.randn(512, d, generator=torch.Generator(device="cuda").manual_seed(d), device="cuda")
    assert torch.equal(row_sum(x[:4].contiguous()), row_sum(x)[:4])
    assert torch.equal(row_sum(x), x.sum(-1))


def _variant_case(n, d_pad, c, seed=0):
    from mlx_mcmc_tpu_torch.benchmarks.flagship_decomposition import make_operands

    return make_operands(n, d_pad, c, seed=seed)


def _check_variant(name, Xp, yp, Z, **plan):
    kernel, plain = glm_variants.VARIANTS[name]
    before = kernel.launches
    a = kernel(Xp, yp, Z, **plan)
    b = kernel(Xp, yp, Z, **plan)
    assert kernel.launches == before + 2
    ll_p, g_p = plain(Xp, yp, Z, **({"tile_rows": plan["tile_rows"]} if "tile_rows" in plan else {}))
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    ll_k, g_k = a
    assert ll_k.shape == (Z.shape[0],) and g_k.shape == Z.shape
    if name == "mm1_pair":
        agree = glm_variants.mm1_pair_agreement(Xp, Z, ll_k, plan["tile_rows"])
        assert len(agree["unexplained"]) == 0 and agree["max_rel_err"] <= 1e-4
        assert len(agree["boundary"]) <= max(1.0, 1e-3 * Z.shape[0])
        assert len(agree["flipped"]) <= max(1.0, 5e-3 * Z.shape[0])
        assert not g_k.any()
        return
    assert bool(((ll_k - ll_p).abs() <= 1e-3 + 1e-5 * ll_p.abs()).all())
    flip = glm_variants.residual_flip(name, Xp, Z)
    assert float((g_k - g_p).abs().max()) <= 1e-4 * float(g_p.abs().max()) + 1e-5 + 2 * flip


_VARIANT_SHAPES = [(10_240, 128, 4096), (777, 112, 300), (130, 48, 1), (4097, 128, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in glm_variants.VARIANTS if n != "mm1_pair"])
@pytest.mark.parametrize("n,d_pad,c", _VARIANT_SHAPES)
def test_variant_kernels_match_plain_version(n, d_pad, c, name):
    # The one-pass family and split2: the reference's shape, ragged N and
    # C, Dp <= 64 (one X box per stage), a partial last chain tile.
    _need_gpu()
    _check_variant(name, *_variant_case(n, d_pad, c))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tanh_y", "tanh_hoist", "exp_hoist"])
@pytest.mark.parametrize("n,d_pad,c", [(10_240, 128, 4096), (777, 112, 300)])
def test_overlap_variants_are_reproducible_and_batch_invariant(n, d_pad, c, name):
    # V4, V5 and V6 (glm_overlap_kernel): two calls give the same bits, and
    # chains 0 to k - 1 of a call with k chains those of the full call.
    _need_gpu()
    Xp, yp, Z = _variant_case(n, d_pad, c)
    kernel = glm_variants.VARIANTS[name][0]
    a, b = kernel(Xp, yp, Z), kernel(Xp, yp, Z)
    subs = {k: kernel(Xp, yp, Z[:k].contiguous()) for k in (4, 129)}
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for k, sub in subs.items():
        assert all(torch.equal(x[:k], y) for x, y in zip(a, sub)), k


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 512, 2048, 2560])
def test_variant_rows_per_split(rows):
    # The benchmarks' sweep of the one-pass plan: the same function.
    _need_gpu()
    Xp, yp, Z = _variant_case(10_240, 128, 512)
    _check_variant("tanh_y", Xp, yp, Z, rows_per_split=rows)
    ll, g = glm_variants.current_cuda(Xp, yp, Z, rows_per_split=rows)
    ll_p, g_p = glm.fused_logistic_vag_reference(Xp, yp, Z)
    torch.cuda.synchronize()
    assert float((ll - ll_p).abs().max()) <= 0.05
    assert float((g - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max()) + 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n,d_pad,c", [(5120, 256, 4096), (1280, 1024, 4096), (777, 304, 70)])
def test_floor_variant_wide(n, d_pad, c):
    # The depth sweep: above Dp = 128 floor takes the wide pair.
    _need_gpu()
    _check_variant("floor", *_variant_case(n, d_pad, c, seed=1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d_pad,c,tile", [(10_240, 128, 4096, 1024), (777, 112, 300, 128),
                                            (130, 48, 5, 64)])
def test_mm1_pair_kernel_matches_plain_version(n, d_pad, c, tile):
    _need_gpu()
    _check_variant("mm1_pair", *_variant_case(n, d_pad, c), tile_rows=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d_pad,c,tile,cluster", [(640, 128, 4096, 64, 4), (777, 112, 300, 64, 4),
                                                    (10_000, 128, 300, 256, 3), (10_000, 128, 300, 1024, 0)])
def test_mm1_pair_clusters_are_reproducible_and_batch_invariant(n, d_pad, c, tile, cluster):
    # mm1_pair's clusters: tiles of one stage on four CTAs (three hold no
    # stage of a tile), N not a multiple of 64, C = 300. Against the plain
    # version; two calls give the same bits, so do clusters of one CTA,
    # and chains 0 to k - 1 of a call with k chains those of the full call.
    _need_gpu()
    Xp, yp, Z = _variant_case(n, d_pad, c)
    _check_variant("mm1_pair", Xp, yp, Z, tile_rows=tile, cluster=cluster)

    def call(z, k=cluster):
        return glm_variants.mm1_pair_cuda(Xp, yp, z, tile_rows=tile, cluster=k)

    a, b, one = call(Z), call(Z), call(Z, 1)
    subs = {k: call(Z[:k].contiguous()) for k in (4, 129)}
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(a, one))
    for k, sub in subs.items():
        assert all(torch.equal(x[:k], y) for x, y in zip(a, sub)), k


@pytest.mark.cuda
def test_mm1_pair_plan_keeps_every_cluster_resident():
    _need_gpu()
    for c in (4096, 300):
        for tile in (64, 256, 1024):
            plan = glm_variants.mm1_pair_plan(c, tile)
            assert 1 <= plan["cluster"] <= max(1, min(8, tile // 128))
            assert plan["cluster"] == 1 or plan["resident"] >= -(-c // 64)


@pytest.mark.cuda
def test_variant_kernels_refuse_what_they_do_not_take():
    _need_gpu()
    Xp, yp, Z = _variant_case(256, 128, 8)
    with pytest.raises(ValueError, match="bf16"):
        glm_variants.floor_cuda(Xp.float(), yp, Z)
    with pytest.raises(ValueError, match="multiple of 64"):
        glm_variants.floor_cuda(Xp, yp, Z, rows_per_split=100)
    with pytest.raises(ValueError, match="tile_rows"):
        glm_variants.mm1_pair_cuda(Xp, yp, Z, tile_rows=100)
    with pytest.raises(ValueError, match="cluster"):
        glm_variants.mm1_pair_cuda(Xp, yp, Z, cluster=9)
    Xw, yw, Zw = _variant_case(256, 256, 8)
    for name in ("mm1_sum", "floor_nosum", "tanh_y", "tanh_hoist", "exp_hoist", "split2"):
        with pytest.raises(RuntimeError, match="CUDA error"):
            glm_variants.VARIANTS[name][0](Xw, yw, Zw)
    with pytest.raises(ValueError, match="Dp <= 128"):
        glm_variants.mm1_pair_cuda(Xw, yw, Zw)
