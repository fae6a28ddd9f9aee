"""The port's roofline accounting against the reference's, on the CPU.

- ``utils/roofline.py``: the reference's ``tests/test_ops.py:85-118``
  (a known device, a bandwidth-bound op, an unknown device) with the
  H100's data-sheet peaks, and the peak by operand dtype (float32 X runs
  on the float32 units: TF32 is off).
- ``bench.roofline_detail`` (the bench line's ``detail.roofline``) against
  the repository's ``bench._mfu_detail`` on the same ``(C, S)`` leaf counts
  and X shapes, with the port's peaks patched to a TPU v5e's so that both
  read the same table: every field equal; ``thin > 1`` gives no lockstep
  fields.
"""

import bench as ref_bench
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch import bench
from mlx_mcmc_tpu_torch.utils import roofline
from mlx_mcmc_tpu_torch.utils.roofline import device_peaks, roofline_report

H100 = "NVIDIA H100 80GB HBM3"


def test_roofline_report_known_device():
    # 1e12 flops in 1 s at AI 2048: the bound is the 989 TFLOP/s peak
    rep = roofline_report(1e12, 1e12 / 2048, 1.0, H100)
    assert rep["achieved_tflops"] == 1.0
    assert rep["peak_tflops"] == 989.0 and rep["hbm_gbs"] == 3350.0
    assert rep["roofline_bound_tflops"] == 989.0
    assert abs(rep["mfu_pct"] - 100.0 / 989.0) < 0.01
    assert rep["arithmetic_intensity"] == 2048.0


def test_roofline_bandwidth_bound():
    # AI = 1 flop/byte: the bound is 3350 GB/s x 1 = 3.35 TFLOP/s
    rep = roofline_report(1e12, 1e12, 0.25, H100)
    assert rep["roofline_bound_tflops"] == 3.4
    assert rep["roofline_frac_pct"] > 100.0 * 4.0 / 3.4 - 1.0


def test_unknown_device_graceful():
    rep = roofline_report(1e12, 1e9, 1.0, "Mystery Accelerator")
    assert "mfu_pct" not in rep and "peak_tflops" not in rep
    assert rep["achieved_tflops"] == 1.0
    assert device_peaks(torch.device("cpu")) == (None, None)
    assert "mfu_pct" not in roofline_report(1e12, 1e9, 1.0, torch.device("cpu"))


@pytest.mark.parametrize("dtype, peak", [(torch.bfloat16, 989.0), (torch.int8, 989.0),
                                         (torch.float32, 67.0), (torch.float64, None)])
def test_peak_follows_the_operand_dtype(dtype, peak):
    assert device_peaks(H100, dtype)[0] == peak
    assert device_peaks("NVIDIA H100 PCIe", dtype) == (None, None)  # not the SXM card


class _FakeTPU:
    device_kind = "TPU v5 lite"


class _Result:
    def __init__(self, steps):
        self.info = type("Info", (), {"num_integration_steps": steps})()


def _steps(chains, draws, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, 64, size=(chains, draws)).astype(np.int32)


@pytest.mark.parametrize("name, x_shape, thin, seed", [
    ("glm100_fused", (10240, 128), 1, 0),  # the reference's padded X
    ("glm100_fused", (10000, 112), 1, 1),  # the port's
    ("glm100", (10000, 100), 1, 2),  # f32 X, autograd: two reads
    ("glm1000_fused", (100000, 1008), 1, 3),
    ("glm100_fused", (10000, 112), 2, 4),  # thinned: no lockstep fields
])
def test_roofline_block_is_the_references(monkeypatch, name, x_shape, thin, seed):
    v5e = {dt: 197.0 for dt in (torch.bfloat16, torch.float32, torch.int8)}
    monkeypatch.setattr(roofline, "DEVICE_PEAKS", {"v5 lite": (v5e, 819.0)})
    cfg = dict(bench.CONFIGS[name], num_chains=64, num_samples=50, thin=thin)
    steps = _steps(64, 50, seed)
    fused = cfg["fused"]
    key = "Xp" if fused else "X"
    j_dtype, t_dtype = (jnp.bfloat16, torch.bfloat16) if fused else (jnp.float32, torch.float32)
    want = ref_bench._mfu_detail(_Result(steps), cfg, {key: jnp.zeros(x_shape, j_dtype)}, 3.21,
                                 _FakeTPU())
    got = bench.roofline_detail(_Result(torch.from_numpy(steps)), cfg,
                                {key: torch.zeros(x_shape, dtype=t_dtype)}, 3.21, "TPU v5 lite")
    assert got == want
    assert ("lockstep_tax" in got) == (thin == 1)
    if thin == 1:
        assert len(got) == 12


def test_lockstep_leaves_is_the_pair_loop():
    # the root, then two leapfrogs a pair iteration until the deepest
    # chain's tree ends: ceil((leaves - 1) / 2) iterations
    steps = torch.tensor([[1, 2, 7], [3, 2, 8], [1, 1, 1]])  # (C, S)
    assert bench.lockstep_leaves(steps).tolist() == [3.0, 3.0, 9.0]
