"""PyTorch/CUDA port of ``mlx_mcmc_tpu``: multi-chain MCMC on one GPU.

Chains are the leading batch axis of every tensor (positions are ``(C, D)``).
Entry points run on CUDA unless the caller passes ``device="cpu"``; without
a GPU they raise rather than fall back. The fused logistic value+grad is a
hand-written Hopper kernel (``csrc/glm_fused.cu``) with a plain PyTorch twin
that serves CPU tensors and the tests.

Checkpoint and resume: ``mlx_mcmc_tpu_torch.io``. The package imports
``torch`` only: nothing of JAX and nothing of ``mlx_mcmc_tpu``.
"""

from mlx_mcmc_tpu_torch.distributions import (
    Bernoulli,
    Beta,
    Binomial,
    Categorical,
    Cauchy,
    Dirichlet,
    Distribution,
    Exp,
    Exponential,
    Gamma,
    HalfNormal,
    Identity,
    Laplace,
    LogNormal,
    MultivariateNormal,
    NegativeBinomial,
    Normal,
    Poisson,
    Sigmoid,
    Softplus,
    StickBreaking,
    StudentT,
    Transform,
    Uniform,
    make_transformed_logprob,
)
from mlx_mcmc_tpu_torch.inference.api import MCMCResult, clear_runner_cache, sample
from mlx_mcmc_tpu_torch.inference.mcmc import MCMC
from mlx_mcmc_tpu_torch.inference.vi import ADVIResult, fit_advi
from mlx_mcmc_tpu_torch.kernels.legacy import hmc, metropolis_hastings, nuts

__all__ = [
    "MCMC",
    "MCMCResult",
    "sample",
    "clear_runner_cache",
    "ADVIResult",
    "fit_advi",
    "metropolis_hastings",
    "hmc",
    "nuts",
    "Distribution",
    "Normal",
    "HalfNormal",
    "Beta",
    "Gamma",
    "Exponential",
    "Categorical",
    "Bernoulli",
    "Binomial",
    "NegativeBinomial",
    "Laplace",
    "Cauchy",
    "Uniform",
    "LogNormal",
    "StudentT",
    "Poisson",
    "Dirichlet",
    "MultivariateNormal",
    "Transform",
    "Identity",
    "Exp",
    "Softplus",
    "Sigmoid",
    "StickBreaking",
    "make_transformed_logprob",
]
