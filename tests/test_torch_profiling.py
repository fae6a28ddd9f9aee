"""``utils/profiling.py`` on the CPU: ``trace_to`` writes one Chrome trace
of the block (also when it raises), and ``gradient_evals`` equals the
reference's on the same leapfrog counts."""

import json
import os

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu.utils.profiling import gradient_evals as j_gradient_evals
from mlx_mcmc_tpu_torch.utils import gradient_evals, trace_to


def _trace(log_dir):
    files = [f for f in os.listdir(log_dir) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(log_dir, files[0])) as f:
        return json.load(f)


def test_trace_to_writes_a_chrome_trace(tmp_path, capsys):
    log_dir = tmp_path / "trace"
    with trace_to(str(log_dir), with_host=True):
        x = torch.ones(64, 64)
        (x @ x).sum()
    trace = _trace(log_dir)
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::mm" in names
    assert str(log_dir) in capsys.readouterr().out


def test_trace_to_writes_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with trace_to(str(tmp_path)):
            torch.ones(3).sum()
            raise ValueError("boom")
    assert _trace(tmp_path)["traceEvents"]


def test_gradient_evals_is_the_references():
    steps = np.random.default_rng(0).integers(1, 64, size=(16, 40)).astype(np.int32)
    info = type("Info", (), {"num_integration_steps": steps})()
    t_info = type("Info", (), {"num_integration_steps": torch.from_numpy(steps)})()
    assert gradient_evals(t_info) == j_gradient_evals(info) == int(steps.sum())
    assert isinstance(gradient_evals(t_info), int)
