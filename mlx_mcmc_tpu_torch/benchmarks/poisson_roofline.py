"""K3 against autograd on the roofline: the hierarchical Poisson regression
at 1000 groups x 100 counts with K = 4 covariates, on the card.

Counterpart of the repository's ``benchmarks/poisson_roofline.py``. The
model with covariates does not collapse to sufficient statistics: every
value+grad reads all N = G * n observations. At C chains a call does

  flops  4 N K C     (X beta forward, X^T r backward)
  exp    N C         (one a count a chain)
  bytes  >= X (N K 4 B) and the chains' parameters and gradients, plus the
         (C, N) residual that an unfused backward pass writes and reads.

Per C in 128, 256, 512: the device ms a call of the full-data density's
autograd value+grad (``engine.make_batched_value_and_grad`` over
``models/poisson.py``'s density, float32 products with TF32 off) and of K3
(``ops/poisson.make_fused_poisson_vag``), beside these bounds at the card's
peaks: HBM bandwidth from ``utils/roofline.device_peaks`` (with and
without the residual), the float32 peak for the flops, and the
transcendental rate of the H100's special-function units, 16 a clock per
SM x 132 SMs x 1.98 GHz, for two exps a count a chain (the forward's and
the backward's reuse). Times are ``bench.device_ms`` (CUDA events, the
host's enqueue hidden); on the CPU, the host clock. ``max_abs_lp_gap``
holds the two log densities' agreement at the timed positions.

    python -m mlx_mcmc_tpu_torch.benchmarks.poisson_roofline [--device cpu]
"""

from __future__ import annotations

import json

import torch

from mlx_mcmc_tpu_torch import bench
from mlx_mcmc_tpu_torch.benchmarks import card, device_from_argv, elapsed_ms
from mlx_mcmc_tpu_torch.inference.engine import make_batched_value_and_grad
from mlx_mcmc_tpu_torch.models import make_poisson_event_rates
from mlx_mcmc_tpu_torch.ops.poisson import make_fused_poisson_vag, prepare_fused_poisson_data
from mlx_mcmc_tpu_torch.ops.ravel import make_flat_logprob
from mlx_mcmc_tpu_torch.utils.roofline import device_peaks

G, N_PER, K = 1000, 100, 4
CHAINS = (128, 256, 512)
# The H100 SXM's special-function units: 16 transcendentals a clock per SM,
# 132 SMs, 1.98 GHz boost.
H100_EXP_PER_S = 16 * 132 * 1.98e9


def bounds(chains: int, num_obs: int, num_groups: int, k: int, hbm_gbs: float,
           f32_tflops: float, exp_per_s: float) -> dict:
    """The reference's bounds (``benchmarks/poisson_roofline.py:208-226``)
    at the given rates: ms a call."""
    flops = 4 * num_obs * k * chains
    exps = num_obs * chains
    bytes_fused = num_obs * k * 4 + 2 * chains * (num_groups + k + 2) * 4
    bytes_saved_resid = 2 * chains * num_obs * 4  # write + read of the (C, N) residual
    return {
        "bound_hbm_with_saved_residual_ms": 1e3 * (bytes_fused + bytes_saved_resid) / (hbm_gbs * 1e9),
        "bound_hbm_fully_fused_ms": 1e3 * bytes_fused / (hbm_gbs * 1e9),
        "bound_exp_ms": 1e3 * (2 * exps) / exp_per_s,  # forward exp + backward reuse
        "bound_f32_flops_ms": 1e3 * flops / (f32_tflops * 1e12),
        "flops": flops,
    }


def _ms(fn, device) -> float:
    if device.type == "cuda":
        return bench.device_ms(fn)
    fn()
    _, ms = elapsed_ms(lambda: [fn() for _ in range(3)], device)
    return ms / 3


def run(device, num_groups: int = G, obs_per_group: int = N_PER, k: int = K,
        chains=CHAINS) -> dict:
    spec = make_poisson_event_rates(num_groups=num_groups, obs_per_group=obs_per_group,
                                    covariate_dim=k, seed=0, device=device)
    flp, z0, _ = make_flat_logprob(spec.log_prob, spec.initial_params, device=device)
    autograd = make_batched_value_and_grad(flp)
    data = prepare_fused_poisson_data(spec.y, spec.X, device=device)
    fused = make_fused_poisson_vag()
    num_obs = num_groups * obs_per_group
    hbm_gbs = device_peaks(device, torch.float32)[1]
    f32_tflops = device_peaks(device, torch.float32)[0]
    exp_per_s = H100_EXP_PER_S if hbm_gbs else None
    rows = []
    for c in chains:
        gen = torch.Generator(device=device).manual_seed(0)
        Z = z0[None, :] + 0.02 * torch.randn(c, z0.shape[0], generator=gen, device=device)
        lp_a, _ = autograd(Z)
        lp_k, _ = fused(Z, data)
        row = {"chains": c, "ms_per_vag": _ms(lambda: autograd(Z), device)}
        row["us_per_chain"] = 1e3 * row["ms_per_vag"] / c
        row["fused_ms_per_vag"] = _ms(lambda: fused(Z, data), device)
        row["fused_speedup_vs_autograd"] = row["ms_per_vag"] / row["fused_ms_per_vag"]
        row["max_abs_lp_gap"] = float((lp_a - lp_k).abs().max())
        if hbm_gbs:
            row.update(bounds(c, num_obs, num_groups, k, hbm_gbs, f32_tflops, exp_per_s))
            row["fused_share_of_bound"] = max(
                row["bound_hbm_fully_fused_ms"], row["bound_exp_ms"],
                row["bound_f32_flops_ms"]) / row["fused_ms_per_vag"]
        rows.append(row)
    return {
        "model": f"poisson regression, G={num_groups}, n={obs_per_group}, K={k}, N={num_obs}",
        "design": ("autograd value+grad of the full-data density and K3, each timed per call "
                   "at the chains' positions (bench.device_ms)"),
        "hbm_gbs": hbm_gbs, "f32_tflops": f32_tflops, "exp_per_s": exp_per_s,
        "rows": rows,
    }


def main() -> None:
    device = device_from_argv()
    smi = card(device)
    print(smi, flush=True)
    print(json.dumps(dict(run(device), device=smi)), flush=True)


if __name__ == "__main__":
    main()
