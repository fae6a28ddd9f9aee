"""Per-chain counter-based random streams: Philox4x32-10.

Counterpart of the reference's per-chain keys
(``fold_in(fold_in(key, chain), t)``, ``mlx_mcmc_tpu/inference/engine.py``):
every number is a pure function of ``(seed, chain, step, block, stream)``,
so chain ``i``'s draws at step ``t`` do not depend on how many chains run
beside it or how they are batched. Philox4x32-10 is the generator of Salmon
et al., "Parallel random numbers: as easy as 1, 2, 3" (SC'11):

- key: the 64-bit ``seed`` as two 32-bit words (low, high);
- counter: ``(chain, step, block, stream)``; one call gives four 32-bit
  words, so block ``b`` holds values ``4b .. 4b+3`` of a stream.

``uniform`` maps a word ``x`` to ``(x >> 8) * 2^-24`` in [0, 1), exactly.
``normal`` uses Box-Muller on word pairs ``(x0, x1)`` and ``(x2, x3)``:
``u1 = ((x0 >> 8) + 1) * 2^-24`` in (0, 1], ``u2 = (x1 >> 8) * 2^-24``,
``sqrt(-2 log u1) * (cos, sin)(2 pi u2)``.

The plain generator has two forms that give the same words.
:func:`philox4x32` is PyTorch on int64 tensors: torch has no unsigned
64-bit arithmetic, so the 32x32 -> 64-bit products split one factor into
16-bit halves and never overflow a signed int64. It is the plain version
on a CUDA tensor, where it must stay torch: the kernel's check and its
plain time compare it with ``csrc/philox.cu`` on the card's own tensors,
and numpy cannot run there. On a CPU tensor the words come from
:func:`_philox4x32_numpy`, whose uint64 products need no split: a CPU run
makes one call per transition at small shapes, where numpy takes a fifth
of torch's per-operation time. ``tests/test_torch_rng.py`` holds the two to
the same words.
``step_draws`` is what the engine calls once per step: on a CUDA tensor
it launches the kernel ``csrc/philox.cu`` (one launch fills the step's
normals and uniform table); on a CPU tensor it takes the plain functions.
``stream_uniforms`` gives the uniforms of any one stream the same way (the
kernel's raw words on the card): the samplers' swap, walker and
resampling uniforms. :func:`normal` and :func:`uniform` are the plain
version on any device; no sampling path calls them.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from mlx_mcmc_tpu_torch import _build, _capture

STREAM_NORMAL = 0
STREAM_UNIFORM = 1
# Streams of the samplers beside the engine: parallel tempering's swap
# uniforms (``inference/tempered.py``) and tempered SMC's resampling
# uniform (``inference/smc.py``).
STREAM_SWAP = 2
STREAM_RESAMPLE = 3

_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # Weyl key increments
_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.2831854820251465  # float32(2 pi), as the kernel uses it
_INV_2_24 = 1.0 / (1 << 24)


def _mulhilo(m: int, x: torch.Tensor):
    """``(hi, lo)`` words of the 64-bit product ``m * x`` (both < 2^32)."""
    p_lo = m * (x & 0xFFFF)  # < 2^48
    p_hi = m * (x >> 16)  # < 2^48
    t = p_lo + ((p_hi & 0xFFFF) << 16)  # < 2^49
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 of four counter words and two key words.

    Each argument is an int64 tensor (or int) holding values in
    [0, 2^32); they broadcast. Returns the four output words.
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _philox4x32_numpy(counter, key):
    """:func:`philox4x32` on uint64 numpy arrays: the same words, with the
    64-bit products taken whole (no 16-bit split) at numpy's per-call cost."""
    c0, c1, c2, c3 = (np.asarray(c, dtype=np.uint64) for c in counter)
    k0, k1 = key
    m0, m1, mask = np.uint64(_M0), np.uint64(_M1), np.uint64(_MASK32)
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ np.uint64(k0), p1 & mask,
                          (p0 >> np.uint64(32)) ^ c3 ^ np.uint64(k1), p0 & mask)
    return c0, c1, c2, c3


def _words(seed: int, chains: torch.Tensor, step: int, blocks: int, streams) -> torch.Tensor:
    """``(len(streams), len(chains), blocks, 4)`` int64 words of each stream
    at ``step``, all in one pass of the generator (on CPU tensors through
    numpy, which takes a tenth of torch's per-op time at the tests' sizes)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (seed & _MASK32, seed >> 32)
    if chains.device.type == "cpu":
        counter = ((chains.numpy().astype(np.int64) & _MASK32)[None, :, None],
                   int(step) & _MASK32, np.arange(blocks)[None, None, :],
                   np.array([int(s) & _MASK32 for s in streams])[:, None, None])
        shape = (len(streams), chains.shape[0], blocks)
        out = np.stack([np.broadcast_to(w, shape) for w in _philox4x32_numpy(counter, key)], -1)
        return torch.from_numpy(out.astype(np.int64))
    c0 = (chains.to(torch.int64) & _MASK32)[None, :, None]
    c2 = torch.arange(blocks, dtype=torch.int64, device=chains.device)[None, None, :]
    c3 = torch.tensor([int(s) & _MASK32 for s in streams], dtype=torch.int64,
                      device=chains.device)[:, None, None]
    out = philox4x32((c0, int(step) & _MASK32, c2, c3), key)
    shape = (len(streams), c0.shape[1], blocks)
    return torch.stack([torch.broadcast_to(w, shape) for w in out], dim=-1)


def words(seed: int, chains: torch.Tensor, step: int, blocks: int, stream: int) -> torch.Tensor:
    """``(len(chains), blocks, 4)`` int64 words of ``stream`` at ``step``."""
    return _words(seed, chains, step, blocks, (stream,))[0]


def _uniform_of(w: torch.Tensor, n: int) -> torch.Tensor:
    w = w.reshape(w.shape[0], -1)[:, :n]
    return (w >> 8).to(torch.float32) * _INV_2_24


def _normal_of(w: torch.Tensor, n: int) -> torch.Tensor:
    u1 = ((w[..., 0::2] >> 8) + 1).to(torch.float32) * _INV_2_24  # (C, B, 2)
    u2 = (w[..., 1::2] >> 8).to(torch.float32) * _INV_2_24
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = u2 * _TWO_PI
    z = torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)], dim=-1)
    return z.reshape(w.shape[0], -1)[:, :n]


def uniform(seed: int, chains: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """``(len(chains), n)`` float32 uniforms in [0, 1)."""
    return _uniform_of(words(seed, chains, step, -(-n // 4), STREAM_UNIFORM), n)


def normal(seed: int, chains: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """``(len(chains), n)`` float32 standard normals by Box-Muller."""
    return _normal_of(words(seed, chains, step, -(-n // 4), STREAM_NORMAL), n)


def step_draws_reference(seed: int, chains: torch.Tensor, step: int, dim: int, n_slots: int):
    """Plain version of the kernel: ``(normals (C, dim), U (C, n_slots, 4))``,
    both streams from one pass of the generator."""
    normal_blocks = -(-dim // 4)
    w = _words(seed, chains, step, max(normal_blocks, n_slots), (STREAM_NORMAL, STREAM_UNIFORM))
    z = _normal_of(w[0, :, :normal_blocks], dim)
    u = _uniform_of(w[1, :, :n_slots], 4 * n_slots).reshape(chains.shape[0], n_slots, 4)
    return z, u


@functools.lru_cache(maxsize=None)
def _kernel_entries():
    lib = _build.load("philox")
    head = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32]
    lib.philox_step_draws.argtypes = head + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.philox_words.argtypes = head + [ctypes.c_uint32, ctypes.c_int] + [ctypes.c_void_p] * 2
    for fn in (lib.philox_step_draws, lib.philox_words):
        fn.restype = ctypes.c_int
    return lib.philox_step_draws, lib.philox_words


def _check_chains(chains: torch.Tensor, per_chain: int) -> None:
    if not chains.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors only")
    if chains.dtype != torch.int64 or chains.dim() != 1 or not chains.is_contiguous():
        raise ValueError(
            f"chains must be a contiguous 1-D int64 tensor, got {chains.dtype} {tuple(chains.shape)}"
        )
    if chains.shape[0] < 1 or chains.shape[0] * per_chain >= 2**31:
        raise ValueError(f"bad sizes: {chains.shape[0]} chains x {per_chain} values")


def words_cuda(seed: int, chains: torch.Tensor, step: int, blocks: int, stream: int) -> torch.Tensor:
    """The kernel's raw words, as :func:`words` gives them: the generator's
    own check, and :func:`stream_uniforms` on the card. Adds one to
    ``words_cuda.launches``."""
    _check_chains(chains, 4 * blocks)
    if blocks < 1:
        raise ValueError(f"blocks must be >= 1, got {blocks}")
    out = torch.empty((chains.shape[0], blocks, 4), dtype=torch.int32, device=chains.device)
    err = _kernel_entries()[1](
        chains.data_ptr(), chains.shape[0], int(seed) & 0xFFFFFFFFFFFFFFFF, int(step) & _MASK32,
        int(stream) & _MASK32, blocks, out.data_ptr(),
        torch.cuda.current_stream(chains.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"philox_words launch failed with CUDA error {err}")
    _capture.count_launch(words_cuda)
    return out.to(torch.int64) & _MASK32


words_cuda.launches = 0


def step_draws_cuda(seed: int, chains: torch.Tensor, step: int, dim: int, n_slots: int):
    """Launch the Philox kernel: one launch fills ``(normals (C, dim),
    U (C, n_slots, 4))`` for ``step``. ``chains`` is an int64 CUDA tensor of
    global chain indices. Adds one to ``step_draws_cuda.launches``."""
    if dim < 1 or n_slots < 0:
        raise ValueError(f"bad sizes: dim={dim}, n_slots={n_slots}")
    _check_chains(chains, dim + 4 * n_slots)
    c = chains.shape[0]
    f32 = dict(dtype=torch.float32, device=chains.device)
    z = torch.empty((c, dim), **f32)
    u = torch.empty((c, n_slots, 4), **f32)
    err = _kernel_entries()[0](
        chains.data_ptr(), c, int(seed) & 0xFFFFFFFFFFFFFFFF, int(step) & _MASK32,
        dim, n_slots, z.data_ptr(), u.data_ptr(),
        torch.cuda.current_stream(chains.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"philox_step_draws launch failed with CUDA error {err}")
    _capture.count_launch(step_draws_cuda)
    return z, u


step_draws_cuda.launches = 0


def step_draws(seed: int, chains: torch.Tensor, step: int, dim: int, n_slots: int):
    """One NUTS step's random inputs for the chains ``chains``: standard
    normals ``(C, dim)`` for the momenta and the uniform table
    ``(C, n_slots, 4)``. The plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if chains.device.type == "cpu":
        return step_draws_reference(seed, chains, step, dim, n_slots)
    return step_draws_cuda(seed, chains, step, dim, n_slots)


def stream_uniforms(seed: int, chains: torch.Tensor, step: int, n: int, stream: int):
    """``(len(chains), n)`` float32 uniforms of ``stream`` at ``step``, value
    ``i`` of a chain from word ``i`` of its counter blocks: one launch of
    the kernel's raw words on a CUDA tensor (:func:`words_cuda`), the plain
    version on a CPU tensor. The words are the same either way."""
    blocks = -(-n // 4)
    if chains.device.type == "cpu":
        return _uniform_of(words(seed, chains, step, blocks, stream), n)
    return _uniform_of(words_cuda(seed, chains, step, blocks, stream), n)
