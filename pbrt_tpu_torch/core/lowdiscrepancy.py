"""Owen-scrambled Sobol' dimensions 0 and 1 — the (0,2)-sequence that the
`zerotwo` sampler draws (counterpart of the Sobol' part of
pbrt_tpu/core/lowdiscrepancy.py). uint32 values live in int64 tensors
(see core/rng.py)."""
from __future__ import annotations

import functools

import numpy as np
import torch

from .rng import M32, mul32
from .types import ONE_MINUS_EPSILON, f32

SOBOL_BITS = 32


@functools.lru_cache(maxsize=None)
def sobol_matrices_2d():
    """(2, 32) MSB-aligned direction vectors of Sobol' dimensions 0 and 1:
    dimension 0 is van der Corput; dimension 1 comes from the primitive
    polynomial x + 1 with m_1 = 1, i.e. m_k = m_{k-1} xor 2·m_{k-1}.
    These are the first two rows of the JAX package's generated table."""
    v = np.zeros((2, SOBOL_BITS), np.uint64)
    for k in range(SOBOL_BITS):
        v[0, k] = 1 << (31 - k)
    m = 1
    for k in range(1, SOBOL_BITS + 1):
        if k > 1:
            m = m ^ (2 * m)
        v[1, k - 1] = (m << (SOBOL_BITS - k)) & M32
    return v.astype(np.int64)


@functools.lru_cache(maxsize=None)
def _byte_tables(dim: int, device):
    """(4, 256) int64: entry [b, j] is the XOR of the direction vectors
    picked by the bits of j in byte b of the index."""
    v = sobol_matrices_2d()[dim]
    t = np.zeros((4, 256), np.int64)
    for b in range(4):
        for j in range(256):
            acc = 0
            for k in range(8):
                if (j >> k) & 1:
                    acc ^= int(v[8 * b + k])
            t[b, j] = acc
    return torch.as_tensor(t, device=device)


def sobol_u32(index, dim: int):
    """XOR-fold of the direction vectors picked by the set bits of index,
    one byte-table lookup per index byte."""
    t = _byte_tables(dim, index.device)
    out = t[0][index & 255]
    for b in range(1, 4):
        out = out ^ t[b][(index >> (8 * b)) & 255]
    return out


def _reverse_bits32(x):
    x = ((x & 0x55555555) << 1) | ((x >> 1) & 0x55555555)
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x << 16) | (x >> 16)) & M32


def u32_to_unit_float(bits):
    u = bits.to(torch.float32) * f32(2.3283064365386963e-10)
    return torch.clamp(u, max=ONE_MINUS_EPSILON)


def sobol_sample(index, dim: int, scramble_seed):
    """Owen-scrambled Sobol' sample in [0, 1). Dimension 0 is the bit
    reversal of the index, so the scramble's leading reversal cancels."""
    x = index if dim == 0 else _reverse_bits32(sobol_u32(index, dim))
    x = (x + scramble_seed) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ mul32(x, c)
    return u32_to_unit_float(_reverse_bits32(x))
