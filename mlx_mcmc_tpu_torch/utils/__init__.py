from mlx_mcmc_tpu_torch.utils.config import AdaptationConfig, MeshConfig, SamplerConfig

__all__ = ["AdaptationConfig", "MeshConfig", "SamplerConfig"]
