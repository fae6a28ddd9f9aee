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

The functions here are plain PyTorch on int64 tensors, on any device: torch
has no unsigned 64-bit arithmetic, so the 32x32 -> 64-bit products split
one factor into 16-bit halves and never overflow a signed int64.
``step_draws`` is what the engine calls once per NUTS step: on a CUDA tensor
it launches the kernel ``csrc/philox.cu`` (one launch fills the step's
normals and uniform table); on a CPU tensor it takes the plain functions.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mlx_mcmc_tpu_torch import _build

STREAM_NORMAL = 0
STREAM_UNIFORM = 1

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


def words(seed: int, chains: torch.Tensor, step: int, blocks: int, stream: int) -> torch.Tensor:
    """``(len(chains), blocks, 4)`` int64 words of ``stream`` at ``step``."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (seed & _MASK32, seed >> 32)
    c0 = (chains.to(torch.int64) & _MASK32)[:, None]
    c2 = torch.arange(blocks, dtype=torch.int64, device=chains.device)[None, :]
    out = philox4x32((c0, int(step) & _MASK32, c2, int(stream) & _MASK32), key)
    return torch.stack([torch.broadcast_to(w, (c0.shape[0], blocks)) for w in out], dim=-1)


def uniform(seed: int, chains: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """``(len(chains), n)`` float32 uniforms in [0, 1)."""
    w = words(seed, chains, step, -(-n // 4), STREAM_UNIFORM).reshape(chains.shape[0], -1)[:, :n]
    return (w >> 8).to(torch.float32) * _INV_2_24


def normal(seed: int, chains: torch.Tensor, step: int, n: int) -> torch.Tensor:
    """``(len(chains), n)`` float32 standard normals by Box-Muller."""
    w = words(seed, chains, step, -(-n // 4), STREAM_NORMAL)  # (C, B, 4)
    u1 = ((w[..., 0::2] >> 8) + 1).to(torch.float32) * _INV_2_24  # (C, B, 2)
    u2 = (w[..., 1::2] >> 8).to(torch.float32) * _INV_2_24
    radius = torch.sqrt(-2.0 * torch.log(u1))
    angle = u2 * _TWO_PI
    z = torch.stack([radius * torch.cos(angle), radius * torch.sin(angle)], dim=-1)
    return z.reshape(chains.shape[0], -1)[:, :n]


def step_draws_reference(seed: int, chains: torch.Tensor, step: int, dim: int, n_slots: int):
    """Plain version of the kernel: ``(normals (C, dim), U (C, n_slots, 4))``."""
    z = normal(seed, chains, step, dim)
    u = uniform(seed, chains, step, 4 * n_slots).reshape(chains.shape[0], n_slots, 4)
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
    """The kernel's raw words, as :func:`words` gives them (a check of the
    generator itself; the engine does not call it). Adds one to
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
    words_cuda.launches += 1
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
    step_draws_cuda.launches += 1
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
