"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Skipped without a GPU. This file imports neither JAX nor the reference
package, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda

Tolerances as in ``chip_smoke.py``: ll within 0.05 nats (f32 sums over N
rows in another order), g within 1e-2 of max|g| + 1e-3 (a last-bit change
of s can flip the bf16 rounding of single residuals).
"""

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch.ops import glm


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,c", [(10_000, 100, 4096), (777, 37, 1000), (1, 5, 65), (130, 128, 64)])
def test_glm_kernel_matches_plain_version(n, d, c):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    rng = np.random.default_rng(2)
    X = (rng.standard_normal((n, d)) / np.sqrt(d)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    data = glm.prepare_fused_logistic_data(torch.from_numpy(X).bfloat16(), torch.from_numpy(y))
    Z = torch.from_numpy(rng.standard_normal((c, d)).astype(np.float32)).cuda()
    before = glm.fused_logistic_vag_cuda.launches
    ll_k, g_k = glm.fused_logistic_value_and_grad(data["Xp"], data["yp"], Z)
    assert glm.fused_logistic_vag_cuda.launches == before + 1
    ll_p, g_p = glm.fused_logistic_vag_reference(data["Xp"], data["yp"], Z)
    torch.cuda.synchronize()
    assert float((ll_k - ll_p).abs().max()) <= 0.05
    assert float((g_k - g_p).abs().max()) <= 1e-2 * float(g_p.abs().max()) + 1e-3


@pytest.mark.cuda
def test_glm_kernel_refuses_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    Xp = torch.zeros(10, 16, dtype=torch.bfloat16, device="cuda")
    y = torch.zeros(10, device="cuda")
    Z = torch.zeros(3, 16, device="cuda")
    with pytest.raises(ValueError, match="bf16"):
        glm.fused_logistic_vag_cuda(Xp.float(), y, Z)
    with pytest.raises(ValueError, match="Dp"):
        glm.fused_logistic_vag_cuda(torch.zeros(10, 144, dtype=torch.bfloat16, device="cuda"), y, Z)
    with pytest.raises(ValueError, match="contiguous"):
        glm.fused_logistic_vag_cuda(Xp, y, torch.zeros(16, 3, device="cuda").T)
