"""HMC kernel state, shared with NUTS.

Counterpart of ``HMCState`` in ``mlx_mcmc_tpu/kernels/hmc.py``; the HMC
transition itself is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class HMCState(NamedTuple):
    position: torch.Tensor  # (C, D)
    log_prob: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D) cached d log_prob/dz
