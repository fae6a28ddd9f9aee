"""Device resolution and the precision policy, applied where the package
first touches a device.

``None`` means CUDA. Without a GPU that raises: a measurement or a run that
asked for the card must never carry on quietly on the CPU. Callers that want
the CPU (the tests) say so with ``device="cpu"``.

TF32 stays off on every path: bf16/TF32-class operand rounding on a value
path collapsed adaptation in the reference (docs/DESIGN.md §4b), so float32
products here run in full float32.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (kernel grids are
    sized to fill them)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
