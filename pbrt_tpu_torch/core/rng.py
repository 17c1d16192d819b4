"""Counter-based stateless RNG (counterpart of pbrt_tpu/core/rng.py).

The PCG output permutation on uint32 keys, emulated in int64 tensors:
every value is kept in [0, 2^32) by masking with 0xFFFFFFFF. A product
of two such values may wrap int64, which keeps its low 32 bits, so the
mask still leaves the uint32 product. Keys may be Python ints or
tensors; the streams equal the JAX package's bit for bit.
"""
from __future__ import annotations

import torch

from .types import ONE_MINUS_EPSILON, f32

M32 = 0xFFFFFFFF
_PCG_MULT = 747796405
_PCG_INC = 2891336453


def as_u32(x):
    """x mod 2^32: an int64 tensor, or a Python int."""
    if torch.is_tensor(x):
        return x.to(torch.int64) & M32
    return int(x) & M32


def mul32(a, c: int):
    """(a * c) mod 2^32 for a in [0, 2^32) and a constant c."""
    return (a * (c & M32)) & M32


def pcg_hash(x):
    """uint32 -> uint32 mix (PCG output permutation RXS-M-XS)."""
    state = (mul32(x, _PCG_MULT) + _PCG_INC) & M32
    word = mul32(((state >> ((state >> 28) + 4)) ^ state), 277803737)
    return (word >> 22) ^ word


def hash_combine(*keys):
    """Fold uint32 keys into one (boost-style combine), broadcasting."""
    h = as_u32(keys[0])
    for k in keys[1:]:
        h = pcg_hash(h ^ ((as_u32(k) + 0x9E3779B9 + ((h << 6) & M32) + (h >> 2)) & M32))
    return h


def uniform_u32(*keys):
    return pcg_hash(hash_combine(*keys))


def uniform_float(*keys):
    """U[0, 1) float32 from integer keys; at least one key is a tensor."""
    bits = uniform_u32(*keys)
    u = (bits >> 8).to(torch.float32) * f32(1.0 / (1 << 24))
    return torch.clamp(u, max=ONE_MINUS_EPSILON)
