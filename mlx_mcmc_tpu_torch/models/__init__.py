from mlx_mcmc_tpu_torch.models.glm import GLMSpec, make_linear_regression, make_logistic_regression
from mlx_mcmc_tpu_torch.models.hierarchical import (
    HierarchicalSpec,
    eight_schools,
    make_hierarchical_normal,
)
from mlx_mcmc_tpu_torch.models.poisson import PoissonSpec, make_poisson_event_rates

__all__ = [
    "GLMSpec",
    "HierarchicalSpec",
    "PoissonSpec",
    "eight_schools",
    "make_hierarchical_normal",
    "make_linear_regression",
    "make_logistic_regression",
    "make_poisson_event_rates",
]
