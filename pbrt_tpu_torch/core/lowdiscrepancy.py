"""Low-discrepancy sequences: Owen-scrambled Sobol', the max-min-distance
film nets, and (scrambled) radical inverses (counterpart of
pbrt_tpu/core/lowdiscrepancy.py).

The Sobol' direction numbers are generated on the host, as the JAX
package generates them: primitive polynomials over GF(2) found by
order-checking x in GF(2)[x]/(p), initial direction numbers from
RandomState(0x5060B), the standard recurrence after them. uint32 values
live in int64 tensors (see core/rng.py); every integer stream equals the
JAX package's bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .rng import M32, hash_combine, mul32, pcg_hash
from .types import ONE_MINUS_EPSILON, divisor, f32

NUM_SOBOL_DIMENSIONS = 160
SOBOL_BITS = 32


# ---------------------------------------------------------- GF(2) helpers

def _polymulmod(a, b, mod, d):
    """a * b mod `mod` (degree d) for bit polynomials."""
    r = 0
    top = 1 << d
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & top:
            a ^= mod
    return r


def _prime_factors(n):
    fs = set()
    f = 2
    while f * f <= n:
        while n % f == 0:
            fs.add(f)
            n //= f
        f += 1
    if n > 1:
        fs.add(n)
    return fs


def _x_order_is_maximal(poly, d):
    """True iff x has order 2^d - 1 in GF(2)[x]/(poly): poly is primitive."""
    n = (1 << d) - 1

    def x_pow(e):
        r, base = 1, 2
        while e:
            if e & 1:
                r = _polymulmod(r, base, poly, d)
            base = _polymulmod(base, base, poly, d)
            e >>= 1
        return r

    return x_pow(n) == 1 and all(x_pow(n // q) != 1 for q in _prime_factors(n))


def _primitive_polynomials(count):
    """The first `count` primitive polynomials over GF(2) by degree, as
    (degree, bitmask with the leading term)."""
    out = [(1, 0b11)]
    d = 2
    while len(out) < count:
        for mid in range(1 << (d - 1)):
            poly = (1 << d) | (mid << 1) | 1
            if _x_order_is_maximal(poly, d):
                out.append((d, poly))
                if len(out) >= count:
                    break
        d += 1
    return out[:count]


@functools.lru_cache(maxsize=None)
def sobol_matrices(n_dims=NUM_SOBOL_DIMENSIONS):
    """(n_dims, 32) int64: MSB-aligned direction vectors v_k."""
    v = np.zeros((n_dims, SOBOL_BITS), np.int64)
    v[0] = [1 << (31 - k) for k in range(SOBOL_BITS)]     # van der Corput
    rng = np.random.RandomState(0x5060B)
    for j, (d, poly) in enumerate(_primitive_polynomials(n_dims - 1), start=1):
        a = [(poly >> (d - i)) & 1 for i in range(1, d)]
        m = [0, 1] + [0] * SOBOL_BITS
        for k in range(2, d + 1):
            m[k] = 2 * int(rng.randint(0, 1 << (k - 1))) + 1
        for k in range(d + 1, SOBOL_BITS + 1):
            acc = m[k - d] ^ (m[k - d] << d)
            for i in range(1, d):
                if a[i - 1]:
                    acc ^= m[k - i] << i
            m[k] = acc
        for k in range(1, SOBOL_BITS + 1):
            v[j, k - 1] = (m[k] << (SOBOL_BITS - k)) & M32
    return v


def _fold_tables(vectors):
    """(..., 32) direction vectors → (..., 4, 256): entry [b, j] is the
    XOR of the vectors picked by the bits of j in byte b of an index."""
    vectors = np.asarray(vectors, np.int64)
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1          # (256, 8)
    v = vectors.reshape(vectors.shape[:-1] + (4, 1, 8))
    return np.bitwise_xor.reduce(np.where(bits.astype(bool), v, 0), axis=-1)


@functools.lru_cache(maxsize=None)
def _sobol_tables(device):
    return torch.as_tensor(_fold_tables(sobol_matrices()), device=device)


def _fold(t, index):
    """XOR-fold of the direction vectors picked by the set bits of
    index, one lookup per index byte; t is (4, 256)."""
    out = t[0][index & 255]
    for b in range(1, 4):
        out = out ^ t[b][(index >> (8 * b)) & 255]
    return out


def sobol_u32(index, dim: int):
    """Sobol' bits of dimension `dim` for uint32 indices."""
    return _fold(_sobol_tables(index.device)[dim], index)


def reverse_bits32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def _scramble_reversed(xr, seed):
    """Owen scrambling of x given its bit reversal xr: the Laine–Karras
    permutation on the reversed value, reversed back."""
    x = (xr + seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ mul32(x, c)
    return reverse_bits32(x)


def owen_scramble_u32(x, seed):
    """Hash-based Owen scrambling (Laine–Karras / Burley)."""
    return _scramble_reversed(reverse_bits32(x), seed)


def u32_to_unit_float(bits):
    u = bits.to(torch.float32) * f32(2.3283064365386963e-10)
    return torch.clamp(u, max=ONE_MINUS_EPSILON)


def sobol_sample(index, dim: int, scramble_seed):
    """Owen-scrambled Sobol' sample in [0, 1). Dimension 0 is the bit
    reversal of the index, so the scramble's leading reversal cancels."""
    xr = index if dim == 0 else reverse_bits32(sobol_u32(index, dim))
    return u32_to_unit_float(_scramble_reversed(xr, scramble_seed))


# ------------------------------------------------------------- max-min

@functools.lru_cache(maxsize=None)
def maxmin_matrix(m):
    """(32,) int64 generator vectors for the y component of the n = 2^m
    max-min-distance net {(i/n, C·i)}: the JAX package's hill climb of
    the least toroidal distance from the Sobol' dimension-1 matrix
    (RandomState(977 + m), 600 steps), numpy in float64 as there."""
    assert 1 <= m <= 10
    n = 1 << m
    idx = np.arange(n, dtype=np.uint32)
    x = idx.astype(np.float64) / n
    dx = np.abs(x[:, None] - x[None, :])
    dx = np.minimum(dx, 1.0 - dx) ** 2
    big = np.eye(n) * 4.0

    def min_d2(vrows):
        y = np.zeros(n, np.uint32)
        for k in range(m):
            bit = ((idx >> np.uint32(k)) & 1).astype(bool)
            y = y ^ np.where(bit, vrows[k], np.uint32(0))
        y = y.astype(np.float64) / 2.0 ** 32
        dy = np.abs(y[:, None] - y[None, :])
        dy = np.minimum(dy, 1.0 - dy) ** 2
        return float((dx + dy + big).min())

    sob = sobol_matrices(2)[1].astype(np.uint32)
    v = sob[:m].copy()
    best = min_d2(v)
    rng = np.random.RandomState(977 + m)
    for _ in range(600):
        k = int(rng.randint(m))
        b = int(rng.randint(m))
        cand = v.copy()
        cand[k] ^= np.uint32(1) << np.uint32(31 - b)
        d = min_d2(cand)
        if d > best:
            v, best = cand, d
    out = sob.copy()
    out[:m] = v
    return out.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _maxmin_table(m, device):
    return torch.as_tensor(_fold_tables(maxmin_matrix(m)), device=device)


def maxmin_sample2(index, m, seed0, seed1):
    """Owen-scrambled (x, y) of the n = 2^m max-min net: x = i/n, y = C·i."""
    xbits = (index << (32 - m)) & M32
    ybits = _fold(_maxmin_table(m, index.device), index)
    return torch.stack([u32_to_unit_float(owen_scramble_u32(xbits, seed0)),
                        u32_to_unit_float(owen_scramble_u32(ybits, seed1))], -1)


# --------------------------------------------------------------- radical

@functools.lru_cache(maxsize=None)
def primes(n=1000):
    """The first n primes (sieve)."""
    limit = max(16, int(n * (np.log(n) + np.log(np.log(n + 2)) + 2)))
    sieve = np.ones(limit, bool)
    sieve[:2] = False
    for p in range(2, int(limit ** 0.5) + 1):
        if sieve[p]:
            sieve[p * p::p] = False
    return np.nonzero(sieve)[0][:n].astype(np.int64)


def _digits(base_index: int, a, permute):
    """32-digit additive fold of a's base-b digits, b the base_index-th
    prime; permute(i, digit) gives the digit written at position i."""
    base = int(primes()[base_index])
    basef = divisor(base, a.device)
    rev = torch.zeros(a.shape, dtype=torch.float32, device=a.device)
    scale = torch.ones(a.shape, dtype=torch.float32, device=a.device)
    for i in range(SOBOL_BITS):
        digit = permute(i, a % base, base).to(torch.float32)
        scale = scale / basef
        rev = rev + digit * scale
        a = torch.div(a, base, rounding_mode="floor")
    return torch.clamp(rev, max=ONE_MINUS_EPSILON)


def radical_inverse(base_index: int, a):
    """Radical inverse of uint32 `a` in the base_index-th prime base."""
    return _digits(base_index, a, lambda i, d, b: d)


def scrambled_radical_inverse(base_index: int, a, pixel_seed):
    """Radical inverse with a hashed digit rotation per digit position."""
    def rotate(i, digit, base):
        return (digit + pcg_hash(hash_combine(pixel_seed, base_index, i)) % base) % base
    return _digits(base_index, a, rotate)
