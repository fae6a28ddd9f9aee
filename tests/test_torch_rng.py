"""Per-chain counter-based random streams (``ops/random.py``).

- Philox4x32-10 reproduces Random123's known-answer vectors and an
  independent pure-Python implementation on random counters and keys.
- A chain's numbers depend on its global index only: chains 4-7 drawn alone
  equal rows 4-7 of chains 0-7.
- Uniform and normal moments, within 5 standard errors over 2^18 draws.
- The engine's draws make NUTS transitions layout-invariant: three steps of
  a 4-chain and an 8-chain batch give bit-identical chains 0-3 on the CPU.
The kernel against this plain version: ``test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest
import torch

from mlx_mcmc_tpu_torch.inference.engine import step_inputs
from mlx_mcmc_tpu_torch.kernels.base import Tunables
from mlx_mcmc_tpu_torch.kernels.nuts import make_nuts_kernel
from mlx_mcmc_tpu_torch.ops import random as prng


def _python_philox(counter, key):
    """Philox4x32-10 on Python ints, written from the paper's definition."""
    mask = 0xFFFFFFFF
    c, (k0, k1) = list(counter), key
    for r in range(10):
        if r:
            k0, k1 = (k0 + 0x9E3779B9) & mask, (k1 + 0xBB67AE85) & mask
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k0) & mask, p1 & mask, ((p0 >> 32) ^ c[3] ^ k1) & mask, p0 & mask]
    return c


@pytest.mark.parametrize(
    "counter,key,expected",
    [
        ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
        ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
        (
            [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344],
            [0xA4093822, 0x299F31D0],
            [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1],
        ),
    ],
    ids=["zeros", "ones", "pi"],
)
def test_philox_known_answers(counter, key, expected):
    out = prng.philox4x32(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter),
        tuple(torch.tensor([k], dtype=torch.int64) for k in key),
    )
    assert [int(w) for w in out] == expected
    assert _python_philox(counter, key) == expected


def test_philox_matches_python_on_random_counters():
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 2**32, size=(64, 6), dtype=np.uint64).astype(np.int64)
    out = prng.philox4x32(tuple(torch.from_numpy(vals[:, i]) for i in range(4)),
                          (torch.from_numpy(vals[:, 4]), torch.from_numpy(vals[:, 5])))
    got = torch.stack(out, dim=1).tolist()
    for row, words in zip(vals.tolist(), got):
        assert words == _python_philox(row[:4], row[4:])


def test_words_follow_the_counter_layout():
    seed = 0xDEADBEEF12345678
    w = prng.words(seed, torch.tensor([3, 9]), 17, 2, prng.STREAM_UNIFORM)
    assert w.shape == (2, 2, 4)
    want = _python_philox([9, 17, 1, prng.STREAM_UNIFORM], [seed & 0xFFFFFFFF, seed >> 32])
    assert w[1, 1].tolist() == want
    u = prng.uniform(seed, torch.tensor([9]), 17, 8)
    assert u[0, 5].item() == (want[1] >> 8) * 2.0**-24


def test_cpu_words_equal_the_torch_generator():
    """CPU tensors take the generator through numpy's uint64 products; the
    plain torch generator (``philox4x32``, what CUDA tensors' plain version
    runs) gives the same words, and the step draws are its transforms."""
    _check_cpu_words(0x0123456789ABCDEF, 0x7FFFFFFE)


@pytest.mark.parametrize("seed, step", [(0, 0), (2**64 - 1, 0x7FFFFFFF), (17, 2299)])
def test_cpu_words_equal_the_torch_generator_at_the_edges(seed, step):
    """The same at the smallest and largest seed, the probe's step and a
    sampling step."""
    _check_cpu_words(seed, step)


def _check_cpu_words(seed, step):
    chains = torch.tensor([0, 5, 4095, 2**31 + 7])
    got = prng._words(seed, chains, step, 9, (prng.STREAM_NORMAL, prng.STREAM_UNIFORM))
    key = (seed & 0xFFFFFFFF, seed >> 32)
    for s, stream in enumerate((prng.STREAM_NORMAL, prng.STREAM_UNIFORM)):
        c0 = chains[:, None]
        c2 = torch.arange(9)[None, :]
        want = prng.philox4x32((c0, step, c2, stream), key)
        want = torch.stack([torch.broadcast_to(w, (4, 9)) for w in want], dim=-1)
        assert torch.equal(got[s], want)
    z, u = prng.step_draws(seed, chains, 3, 30, 9)
    assert torch.equal(z, prng.normal(seed, chains, 3, 30))
    assert torch.equal(u.reshape(4, -1), prng.uniform(seed, chains, 3, 36))


@pytest.mark.parametrize("fn", [prng.uniform, prng.normal], ids=["uniform", "normal"])
def test_a_chains_numbers_do_not_depend_on_the_batch(fn):
    all8 = fn(123, torch.arange(8), 5, 37)
    upper = fn(123, torch.arange(4, 8), 5, 37)
    assert torch.equal(all8[4:], upper)
    assert torch.equal(fn(123, torch.tensor([6, 2]), 5, 37), all8[[6, 2]])
    assert not torch.equal(fn(123, torch.arange(8), 6, 37), all8)  # another step
    assert not torch.equal(fn(124, torch.arange(8), 5, 37), all8)  # another seed
    z, u = prng.step_draws(123, torch.arange(8), 5, 37, 16)
    z4, u4 = prng.step_draws(123, torch.arange(4, 8), 5, 37, 16)
    assert torch.equal(z[4:], z4) and torch.equal(u[4:], u4) and u.shape == (8, 16, 4)


def test_uniform_and_normal_moments():
    n = 1 << 15
    u = prng.uniform(7, torch.arange(8), 0, n).double().flatten()
    z = prng.normal(7, torch.arange(8), 0, n).double().flatten()
    m = u.numel()
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / m**0.5
    assert abs(float(u.var()) - 1 / 12) < 5 * (1 / 180) ** 0.5 / m**0.5
    assert abs(float(z.mean())) < 5 / m**0.5
    assert abs(float(z.var()) - 1.0) < 5 * 2**0.5 / m**0.5
    assert abs(float((z**3).mean())) < 5 * 15**0.5 / m**0.5
    assert abs(float((z.abs() > 1.959964).double().mean()) - 0.05) < 5 * (0.05 * 0.95 / m) ** 0.5


def test_nuts_transitions_are_layout_invariant():
    inv_var = torch.tensor([1.0, 0.25, 4.0])

    def vag(Z):
        return -0.5 * (Z * Z * inv_var).sum(-1), -Z * inv_var

    tun = Tunables(torch.tensor(0.4), torch.ones(3))
    out = {}
    for c in (4, 8):
        chains = torch.arange(c)
        init_fn, step_fn = make_nuts_kernel(vag, max_tree_depth=6)
        state = init_fn(prng.step_draws(11, chains, 999, 3, 0)[0])
        depths = []
        for t in range(3):
            r0, U = step_inputs(11, chains, t, tun.inv_mass_diag, 32)
            state, info, _ = step_fn(state, tun, r0, U)
            depths.append(info.tree_depth)
        out[c] = (state.position, state.log_prob, torch.stack(depths, 1))
    for a, b in zip(out[4], out[8]):
        assert torch.equal(a, b[:4])
    assert len(out[8][2].unique()) > 1  # trees of several depths
