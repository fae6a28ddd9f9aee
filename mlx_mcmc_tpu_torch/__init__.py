"""PyTorch/CUDA port of ``mlx_mcmc_tpu``: multi-chain NUTS on one GPU.

Chains are the leading batch axis of every tensor (positions are ``(C, D)``).
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU they raise rather than fall back. The fused logistic value+grad is a
hand-written Hopper kernel (``csrc/glm_fused.cu``) with a plain PyTorch twin
that serves CPU tensors and the tests.

The package imports ``torch`` only: nothing of JAX and nothing of
``mlx_mcmc_tpu``.
"""

from mlx_mcmc_tpu_torch.inference.api import MCMCResult, sample

__all__ = ["MCMCResult", "sample"]
