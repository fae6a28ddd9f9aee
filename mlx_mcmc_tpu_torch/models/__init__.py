from mlx_mcmc_tpu_torch.models.glm import GLMSpec, make_logistic_regression
from mlx_mcmc_tpu_torch.models.hierarchical import HierarchicalSpec, eight_schools

__all__ = ["GLMSpec", "HierarchicalSpec", "eight_schools", "make_logistic_regression"]
