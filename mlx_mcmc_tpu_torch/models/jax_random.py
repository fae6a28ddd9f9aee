"""The reference's random streams, in numpy: jax's threefry2x32 PRNG.

The reference makes its datasets with ``jax.random`` (``mlx_mcmc_tpu/models/
glm.py``). This module reproduces the streams of jax 0.9's default
implementation, threefry2x32 with ``jax_threefry_partitionable`` on, without
importing JAX, so the port samples the reference's own data:

- ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)``: the words
  ``[seed >> 32, seed & 0xFFFFFFFF]``.
- ``split``, ``bits``, ``uniform`` and ``bernoulli`` are bit for bit those of
  ``jax.random``: element ``i`` (in C order) is threefry2x32 of the key over
  the 64-bit counter ``i``, split into its high and low words.
- ``normal`` is ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv``
  polynomial (Giles, "Approximating the erfinv function") over XLA's CPU
  ``log1p``: a Cephes rational function below |t| = sqrt(2) - 1 and XLA's
  Cephes ``log`` polynomial of 1 + t above it (not the correctly rounded
  logarithm: that differs in ~20% of values). XLA's CPU code fuses each
  multiply-add into one FMA; numpy has no float32 FMA, so ``_fma`` forms it
  in float64 (where the product is exact) and rounds once. A value can
  still differ from XLA's in its last bit where the float64 sum rounds
  first (no such value turned up in the checks made).

- ``poisson`` is ``jax.random.poisson`` (jax 0.9's ``_poisson``): Knuth's
  product of uniforms below rate 10 and Hoermann's transformed rejection at
  and above it, both run over the whole array with the same key, as jax
  runs them. The rejection loop goes on until every element has been
  accepted, the rate-1e5 placeholders of the Knuth elements included, and
  an element's count is the one of its last acceptance, so the count of
  iterations, and with it every count, hangs on each accept decision. Those
  compare a log density against ``lgamma``, which is XLA's float32 Lanczos
  form (``lgamma``; scipy's differs from it in 39% of the integers up to
  2e5, by up to 0.3) with its multiply-adds fused as XLA fuses them.

Because element ``i`` depends on ``i`` alone, any range of elements can be
made on its own: ``normal``, ``uniform`` and ``bits`` generate in chunks of
``CHUNK`` elements on ``THREADS`` threads, so a 10^8-element array never
holds more than ~100 MB of temporaries a thread. numpy only: no JAX, no
torch.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CHUNK = 1 << 20
THREADS = min(8, os.cpu_count() or 1)  # numpy releases the GIL in its loops

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)

# XLA's float32 erf_inv coefficients (highest degree first), for
# w = -log1p(-x^2) < 5 and for w >= 5, as float32.
_ERFINV_LT5 = tuple(np.float32(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941,
))
_ERFINV_GE5 = tuple(np.float32(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682,
))


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as two uint32 words."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of the counter words ``(x0, x1)``
    under the key ``(k0, k1)``; returns the two output words."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1) ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, np.uint32) + ks[0]
        x1 = np.asarray(x1, np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def _counters(start: int, stop: int):
    """The high and low words of the 64-bit counters ``start .. stop-1``."""
    i = np.arange(start, stop, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), i.astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``num`` keys, shape ``(num, 2)``."""
    b0, b1 = threefry2x32(key[0], key[1], *_counters(0, num))
    return np.stack([b0, b1], axis=1)


def _generate(shape, fill, dtype) -> np.ndarray:
    """An array of ``shape`` whose C-order elements ``[a, b)`` are
    ``fill(a, b)``, made ``CHUNK`` elements at a time on ``THREADS``
    threads."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    out = np.empty(size, dtype)

    def run(a):
        b = min(size, a + CHUNK)
        out[a:b] = fill(a, b)

    starts = range(0, size, CHUNK)
    if len(starts) <= 1 or THREADS <= 1:
        for a in starts:
            run(a)
    else:
        with ThreadPoolExecutor(min(THREADS, len(starts))) as pool:
            list(pool.map(run, starts))
    return out.reshape(shape)


def _bits(key, a: int, b: int) -> np.ndarray:
    b0, b1 = threefry2x32(key[0], key[1], *_counters(a, b))
    return b0 ^ b1


def bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)``: uint32 words."""
    return _generate(shape, lambda a, b: _bits(key, a, b), np.uint32)


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 values, rounded once to float32."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(np.float32)


def _uniform(key, a: int, b: int, lo: np.float32, hi: np.float32) -> np.ndarray:
    mant = (_bits(key, a, b) >> np.uint32(9)) | np.uint32(0x3F800000)
    f = mant.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(f, hi - lo, lo))  # XLA fuses f * (hi - lo) + lo


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    return _generate(shape, lambda a, b: _uniform(key, a, b, lo, hi), np.float32)


def _bits32(word: int) -> np.float32:
    return np.array([word], np.uint32).view(np.float32)[0]


_LOG_P = tuple(_bits32(w) for w in (
    0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
    0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA,
))
_LOG_Q1, _LOG_Q2, _SQRT_HALF = _bits32(0xB95E8083), _bits32(0x3F318000), _bits32(0x3F3504F3)

# Cephes log1p: numerator and denominator coefficients, highest degree first.
_LOG1P_NUM = (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1,
)
_LOG1P_DEN = (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1,
)


def _log(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive normal ``x``."""
    f32 = np.float32
    m, e = np.frexp(x)
    m, e = m.astype(f32), e.astype(f32)
    small = m < _SQRT_HALF
    e = e - small.astype(f32)
    m = (m - f32(1.0)) + np.where(small, m, f32(0.0))
    m2 = m * m
    m3 = m2 * m
    y = _fma(_fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = _fma(_fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = _fma(_fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = _fma(_fma(y, m3, y1), m3, y2)
    y = _fma(y, m3, _LOG_Q1 * e)
    return ((m - m2 * f32(0.5)) + y) + _LOG_Q2 * e


def _log1p(t: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` of ``t`` in (-1, 0]."""
    f32 = np.float32
    out = np.empty_like(t)
    small = np.abs(t) < f32(0.41421356237309504880)
    ts = t[small]
    num = np.zeros_like(ts)
    den = np.zeros_like(ts)
    for c_num, c_den in zip(_LOG1P_NUM, _LOG1P_DEN):
        num = _fma(num, ts, f32(c_num))
        den = _fma(den, ts, f32(c_den))
    t2 = ts * ts
    out[small] = (ts * t2) * (num / den) + f32(-0.5) * t2 + ts
    out[~small] = _log(t[~small] + f32(1.0))
    return out


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``erf_inv`` of float32 ``x`` in (-1, 1)."""
    f32 = np.float32
    x = np.asarray(x, f32)
    w = -_log1p(-x * x)
    p = np.empty_like(x)
    lt = w < f32(5.0)
    for sel, coeffs in ((lt, _ERFINV_LT5), (~lt, _ERFINV_GE5)):
        ws = w[sel] - f32(2.5) if coeffs is _ERFINV_LT5 else np.sqrt(w[sel]) - f32(3.0)
        ps = np.full_like(ws, coeffs[0])
        for c in coeffs[1:]:
            ps = _fma(ps, ws, c)
        p[sel] = ps
    return p * x


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    sqrt2 = np.float32(np.sqrt(2.0))

    def fill(a, b):
        return sqrt2 * erf_inv(_uniform(key, a, b, lo, np.float32(1.0)))

    return _generate(shape, fill, np.float32)


def bernoulli(key: np.ndarray, p, shape=None) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for float32 ``p``."""
    p = np.asarray(p, np.float32)
    return uniform(key, p.shape if shape is None else shape) < p


def _log_or_minus_inf(x: np.ndarray) -> np.ndarray:
    """``_log`` of non-negative ``x``, with ``log(0) = -inf`` as XLA has it."""
    out = np.full(x.shape, -np.inf, np.float32)
    pos = x > 0
    out[pos] = _log(x[pos])
    return out


# XLA's float32 lgamma: Lanczos with g = 7, its base coefficient and the
# eight terms' coefficients rounded to float32.
_LANCZOS_BASE = np.float32(0.99999999999980993227684700473478)
_LANCZOS = tuple(np.float32(c) for c in (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554707,
    9.984369578019570859563e-6, 1.50563273514931155834e-7,
))
_LOG_LANCZOS_T = np.float32(math.log(7.5))
_INV_LANCZOS_T = np.float32(1.0 / 7.5)  # XLA multiplies by the reciprocal
_LOG_SQRT_TWO_PI = np.float32((math.log(2.0) + math.log(math.pi)) / 2.0)


def lgamma(x) -> np.ndarray:
    """XLA's float32 ``lgamma`` (``jax.lax.lgamma``) of float32 ``x >= 0.5``.

    Raises for ``x < 0.5``, where XLA reflects (lgamma(x) = log(pi) -
    lgamma(1 - x) - log|sin(pi x)|): ``poisson`` needs it only at k + 1 >= 1.
    """
    f32 = np.float32
    x = np.asarray(x, f32)
    if (x < 0.5).any() or np.isnan(x).any():
        raise ValueError("lgamma takes x >= 0.5 only (no reflection branch)")
    z = x - f32(1.0)
    acc = np.full_like(z, _LANCZOS_BASE)
    for i, c in enumerate(_LANCZOS):
        acc = acc + c / ((z + f32(i)) + f32(1.0))
    t = f32(7.5) + z
    log_t = _LOG_LANCZOS_T + _log1p(z * _INV_LANCZOS_T)
    inner = (z + f32(0.5)) - t / log_t
    return _fma(inner, log_t, _LOG_SQRT_TWO_PI) + _log(acc)


def _poisson_knuth(key: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """Knuth's algorithm as ``jax.random._poisson_knuth``: count the
    uniforms whose log-product stays above ``-lam``."""
    k = np.zeros(lam.shape, np.int32)
    log_prod = np.zeros(lam.shape, np.float32)
    neg_lam = -lam
    while (log_prod > neg_lam).any():
        key, sub = split(key)
        k = np.where(log_prod > neg_lam, k + 1, k)
        log_prod = log_prod + _log_or_minus_inf(uniform(sub, lam.shape))
    return k - 1


def _poisson_rejection(key: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """Hoermann's transformed rejection as ``jax.random._poisson_rejection``
    (float32; XLA fuses each multiply-add)."""
    f32 = np.float32
    log_lam = _log(lam)
    b = _fma(f32(2.53), np.sqrt(lam), f32(0.931))
    a = _fma(f32(0.02483), b, f32(-0.059))
    inv_alpha = f32(1.1239) + f32(1.1328) / (b - f32(3.4))
    v_r = f32(0.9277) - f32(3.6224) / (b - f32(2.0))
    k_out = np.full(lam.shape, -1.0, f32)
    accepted = np.zeros(lam.shape, bool)
    while not accepted.all():
        key, sub0, sub1 = split(key, 3)
        u = uniform(sub0, lam.shape) - f32(0.5)
        v = uniform(sub1, lam.shape)
        u_shifted = f32(0.5) - np.abs(u)
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            k = np.floor(_fma(f32(2.0) * a / u_shifted + b, u, lam) + f32(0.43))
            s = _log_or_minus_inf(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        # t = -lam + k log(lam) - lgamma(k + 1); only where k >= 0, since
        # k < 0 is rejected whatever t is.
        t = np.full(lam.shape, -np.inf, f32)
        ok = k >= 0
        t[ok] = _fma(k[ok], log_lam[ok], -lam[ok]) - lgamma(k[ok] + f32(1.0))
        accept1 = (u_shifted >= f32(0.07)) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < f32(0.013)) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        k_out = np.where(accept, k, k_out)  # every acceptance overwrites
        accepted |= accept
    return k_out.astype(np.int32)


def poisson(key: np.ndarray, lam) -> np.ndarray:
    """``jax.random.poisson(key, lam)`` for float32 rates ``lam``: int32
    counts of ``lam``'s shape."""
    f32 = np.float32
    lam = np.asarray(lam, f32)
    use_knuth = np.isnan(lam) | (lam < f32(10.0))
    counts = np.where(
        use_knuth,
        _poisson_knuth(key, np.where(use_knuth, lam, f32(0.0))),
        _poisson_rejection(key, np.where(use_knuth, f32(1e5), lam)),
    )
    return np.where(lam == 0, 0, counts).astype(np.int32)
