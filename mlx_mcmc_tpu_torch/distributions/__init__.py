from mlx_mcmc_tpu_torch.distributions.base import Distribution
from mlx_mcmc_tpu_torch.distributions.normal import Normal

__all__ = ["Distribution", "Normal"]
