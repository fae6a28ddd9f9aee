"""Profiling helpers: a trace of a block, and exact gradient counts.

Counterpart of ``mlx_mcmc_tpu/utils/profiling.py``. ``trace_to`` records
the enclosed block with ``torch.profiler`` (the host's operators and, where
a card is present, its kernels and copies) and writes one Chrome trace into
a directory; ``gradient_evals`` sums the exact per-draw leapfrog counts that
the kernels record in ``TransitionInfo.num_integration_steps``.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_to(log_dir: str, with_host: bool = False):
    """Trace the enclosed block with ``torch.profiler`` (CPU activity, and
    CUDA where a card is present) and write it into ``log_dir`` as one
    Chrome trace, ``trace_<pid>_<ns>.json`` (open it in Perfetto or
    ``chrome://tracing``); also when the block raises. ``with_host`` prints
    the file's path."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        if with_host:
            print(f"profiler trace written to {path}")


def gradient_evals(info) -> int:
    """Total gradient (leapfrog) evaluations recorded by a run's
    TransitionInfo: exact, not estimated."""
    return int(torch.as_tensor(info.num_integration_steps).sum())
