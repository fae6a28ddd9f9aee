"""Kernel launches and pinned tensors under CUDA graph capture.

A kernel wrapper launches once per call when it runs eagerly. Called while
``inference/graphs.py`` captures a graph, it launches nothing: the graph
launches the kernel at every replay. So a wrapper reports each launch
through :func:`count_launch`. Eagerly, that adds one to the wrapper's
``launches``. Under a :func:`recording`, it adds one to the recording
instead, and each replay of the captured graph adds the recorded count
(:class:`mlx_mcmc_tpu_torch.inference.graphs.CapturedGraph`).

A captured launch keeps the raw pointers that it was given: the data, the
launch workspace and the tensor maps, which encode workspace addresses.
Wrappers hand those tensors to :func:`pin`, and the recording keeps them
for as long as its graph lives, even after a cache has dropped them.
"""

from __future__ import annotations

import collections
import contextlib

import torch

_RECORDINGS: list = []


class Recording:
    """What one capture recorded: ``launches`` per kernel wrapper and the
    ``pinned`` objects whose memory the graph reads or writes."""

    def __init__(self):
        self.launches = collections.Counter()
        self.pinned = []


@contextlib.contextmanager
def recording():
    """Record the launches and pins of the kernel wrappers called inside."""
    rec = Recording()
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.pop()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: counted by the recording, if one
    is open, else added to ``wrapper.launches``. A capture without a
    recording raises, since its launches could not be counted."""
    if _RECORDINGS:
        _RECORDINGS[-1].launches[wrapper] += 1
    elif torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{wrapper.__name__} was captured into a CUDA graph outside "
            "mlx_mcmc_tpu_torch.inference.graphs, which counts its launches")
    else:
        wrapper.launches += 1


def pin(*objs) -> None:
    """Keep ``objs`` alive for as long as the graph being recorded lives."""
    if _RECORDINGS:
        _RECORDINGS[-1].pinned.extend(objs)
