"""Checkpoint and resume of sampler runs, mid-warmup and mid-sampling
(``io/checkpoint.py``), in the reference's npz format."""

from mlx_mcmc_tpu_torch.io.checkpoint import (
    load_checkpoint,
    resume,
    resume_warmup,
    run_warmup,
    save_checkpoint,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "resume",
    "run_warmup",
    "resume_warmup",
]
