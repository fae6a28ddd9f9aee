"""Carry data and sampler state from the reference package into the port.

Inputs are numpy views of the reference's arrays (``np.asarray`` of each
leaf), so this module imports neither JAX nor the reference package. bf16
arrays arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects: they are upcast to float32 (exact) and cast back to bf16.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from mlx_mcmc_tpu_torch._device import resolve_device
from mlx_mcmc_tpu_torch.kernels.adaptation import AdaptationState, DualAveragingState
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.hmc import HMCState
from mlx_mcmc_tpu_torch.ops.glm import transpose_f32
from mlx_mcmc_tpu_torch.ops.math import WelfordState

# The reference's ROWS_PER_GROUP (mlx_mcmc_tpu/ops/pallas/poisson.py): each
# group's counts are padded to this many rows in its Poisson pytree.
_POISSON_ROWS_PER_GROUP = 128


def to_tensor(x: Any, device=None) -> torch.Tensor:
    """numpy (or array-like) -> tensor, keeping bf16 as bf16."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def fused_logistic_data_from_jax(np_dict: Mapping[str, Any], device=None) -> dict:
    """The reference's ``prepare_fused_logistic_data`` pytree -> port data.

    Its zero-padded rows stay as rows of ``Xp``: each adds ``-log 2`` in the
    kernel, and ``pad_const`` adds it back, as in the reference. int8 data
    (``quantize="int8"``) keep their int8 ``Xp`` and float32 ``col_scale``.
    """
    dev = resolve_device(device)
    Xp = to_tensor(np_dict["Xp"], dev).contiguous()
    yp = to_tensor(np_dict["yp"], dev).float().reshape(-1).contiguous()
    data = {
        "Xp": Xp,
        "yp": yp,
        "pad_const": float(np.asarray(np_dict["pad_const"])),
        "dim": int(np.asarray(np_dict["dim"]).shape[0]),
    }
    if "col_scale" in np_dict:
        data["col_scale"] = to_tensor(np_dict["col_scale"], dev).float().contiguous()
    if Xp.dtype == torch.float32:
        data["XpT"] = transpose_f32(Xp)
    return data


def fused_linear_data_from_jax(np_dict: Mapping[str, Any], device=None) -> dict:
    """The reference's ``prepare_fused_linear_data`` pytree -> port data.

    Its zero-padded rows (y = 0) stay as rows of ``Xp``: they add nothing to
    a Gaussian sum of squares. Its ``ll_norm`` and ``inv_noise_var`` carry
    over as floats; the ``tile`` marker has no counterpart.
    """
    dev = resolve_device(device)
    Xp = to_tensor(np_dict["Xp"], dev).contiguous()
    data = {
        "Xp": Xp,
        "yp": to_tensor(np_dict["yp"], dev).float().reshape(-1).contiguous(),
        "ll_norm": float(np.asarray(np_dict["ll_norm"])),
        "inv_noise_var": float(np.asarray(np_dict["inv_noise_var"])),
        "dim": int(np.asarray(np_dict["dim"]).shape[0]),
    }
    if Xp.dtype == torch.float32:
        data["XpT"] = transpose_f32(Xp)
    return data


def fused_poisson_data_from_jax(np_dict: Mapping[str, Any], device=None) -> dict:
    """The reference's ``prepare_fused_poisson_data`` pytree -> port data.

    Strips the TPU layout: the block-diagonal ``E`` columns of ``Xa``, the
    padding of each group to the reference's ``ROWS_PER_GROUP`` rows and the
    padded groups.
    The per-group centering rates come from ``ym``'s columns and ``c0`` is
    kept as it is, so the log density is the reference's.
    """
    dev = resolve_device(device)
    G = int(np.asarray(np_dict["G"]).shape[0])
    K = int(np.asarray(np_dict["K"]).shape[0])
    Xa = np.asarray(np_dict["Xa"], np.float32)
    ym = np.asarray(np_dict["ym"], np.float32)
    Xa = Xa.reshape(-1, _POISSON_ROWS_PER_GROUP, Xa.shape[-1])
    ym = ym.reshape(-1, _POISSON_ROWS_PER_GROUP, 4)
    n = int(ym[0, :, 1].sum())  # the mask column: real rows of a group
    return {
        "X": to_tensor(np.ascontiguousarray(Xa[:G, :n, :K]), dev),
        "y": to_tensor(np.ascontiguousarray(ym[:G, :n, 0]), dev),
        "shat": to_tensor(np.ascontiguousarray(ym[:G, 0, 2]), dev),
        "lamhat": to_tensor(np.ascontiguousarray(ym[:G, 0, 3]), dev),
        "c0": float(np.asarray(np_dict["c0"])),
        "G": G,
        "K": K,
    }


def hier_normal_data_from_jax(np_dict: Mapping[str, Any], device=None) -> dict:
    """The reference's ``prepare_hier_normal_data`` pytree -> port data:
    ``ybar`` as a float32 tensor, its 0-d ``n_per_group``, ``c0`` and
    ``inv_noise_var`` as floats (``ops/suffstats.py``)."""
    dev = resolve_device(device)
    return {
        "ybar": to_tensor(np_dict["ybar"], dev).float().contiguous(),
        **{k: float(np.asarray(np_dict[k])) for k in ("n_per_group", "c0", "inv_noise_var")},
    }


def poisson_rates_data_from_jax(np_dict: Mapping[str, Any], device=None) -> dict:
    """The reference's ``prepare_poisson_rates_data`` pytree -> port data:
    the group sums ``S`` as a float32 tensor, ``n_per_group`` and ``c0`` as
    floats."""
    dev = resolve_device(device)
    return {
        "S": to_tensor(np_dict["S"], dev).float().contiguous(),
        "n_per_group": float(np.asarray(np_dict["n_per_group"])),
        "c0": float(np.asarray(np_dict["c0"])),
    }


def params_from_jax(params: Mapping[str, Any], device=None) -> dict:
    """Initial-params dict: every leaf as a float32 tensor."""
    dev = resolve_device(device)
    return {
        k: params_from_jax(v, dev) if isinstance(v, Mapping) else to_tensor(v, dev).float()
        for k, v in params.items()
    }


def tunables_from_jax(tunables, device=None) -> Tunables:
    dev = resolve_device(device)
    return Tunables(
        step_size=to_tensor(tunables.step_size, dev).float(),
        inv_mass_diag=to_tensor(tunables.inv_mass_diag, dev).float(),
    )


def adaptation_state_from_jax(state, device=None) -> AdaptationState:
    dev = resolve_device(device)
    f = lambda x: to_tensor(x, dev).float()  # noqa: E731
    return AdaptationState(
        da=DualAveragingState(*(f(x) for x in state.da)),
        welford=WelfordState(*(f(x) for x in state.welford)),
        inv_mass_diag=f(state.inv_mass_diag),
    )


def hmc_state_from_jax(state, device=None) -> HMCState:
    """A chain-batched ``HMCState`` (leading axis = chains)."""
    dev = resolve_device(device)
    return HMCState(*(to_tensor(x, dev).float() for x in state))
