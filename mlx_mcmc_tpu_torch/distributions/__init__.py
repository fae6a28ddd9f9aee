from mlx_mcmc_tpu_torch.distributions.base import Distribution
from mlx_mcmc_tpu_torch.distributions.beta import Beta
from mlx_mcmc_tpu_torch.distributions.categorical import Categorical
from mlx_mcmc_tpu_torch.distributions.exponential import Exponential
from mlx_mcmc_tpu_torch.distributions.extras import (
    Bernoulli,
    Binomial,
    Cauchy,
    Dirichlet,
    Laplace,
    LogNormal,
    MultivariateNormal,
    NegativeBinomial,
    Poisson,
    StudentT,
    Uniform,
)
from mlx_mcmc_tpu_torch.distributions.gamma import Gamma
from mlx_mcmc_tpu_torch.distributions.halfnormal import HalfNormal
from mlx_mcmc_tpu_torch.distributions.normal import Normal
from mlx_mcmc_tpu_torch.distributions.transforms import (
    Exp,
    Identity,
    Sigmoid,
    Softplus,
    StickBreaking,
    Transform,
    get_transform,
    make_transformed_logprob,
)

__all__ = [
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
    "get_transform",
    "make_transformed_logprob",
]
