"""The sample stream both renderers draw from, written out from its
definition: a uniform per (seed, pixel, sample, dimension) of an
Owen-scrambled (0,2)-sequence ("zerotwo").

A 1D value is the sample index's van der Corput radical inverse, Owen
scrambled by a hash of (seed, pixel, dim); a 2D value pairs it with
the second Sobol' dimension, each scrambled by its own hash of (seed,
pixel, dim, axis). The hash is the PCG output permutation folded over
the keys; the scramble is Laine and Karras's on the bit-reversed value.
Integers are uint32 values held in int64 tensors, and every product is
formed in 16-bit halves so that none leaves int64."""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
LK_ROUNDS = (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6)
LARGEST_BELOW_ONE = 1.0 - 2.0 ** -24


def mulmod(x, c):
    """x * c mod 2^32 for x a tensor of uint32 values and c a constant."""
    c &= M32
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def pcg(x):
    state = (mulmod(x, 747796405) + 2891336453) & M32
    word = mulmod((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def combine(first, *rest):
    """Fold keys into one uint32 (boost's hash_combine, each step mixed by pcg)."""
    h = first & M32
    for k in rest:
        h = pcg(h ^ ((k + GOLDEN + ((h << 6) & M32) + (h >> 2)) & M32))
    return h


def reverse32(x):
    out = torch.zeros_like(x)
    for i in range(32):
        out = out | (((x >> i) & 1) << (31 - i))
    return out


def _second_dim_vectors():
    """Direction numbers of Sobol's second dimension (primitive
    polynomial x + 1): m_1 = 1, m_k = m_{k-1} xor 2 m_{k-1}; v_k = m_k << (32 - k)."""
    m, out = 1, []
    for k in range(1, 33):
        if k > 1:
            m = m ^ (m << 1)
        out.append((m << (32 - k)) & M32)
    return out


SOBOL2 = _second_dim_vectors()


def sobol2(index):
    acc = torch.zeros_like(index)
    for k, v in enumerate(SOBOL2):
        acc = acc ^ (((index >> k) & 1) * v)
    return acc


def scrambled_unit(bits_reversed, seed):
    """Owen scrambling of a value given bit-reversed, as a float in [0, 1)."""
    x = (bits_reversed + seed) & M32
    for c in LK_ROUNDS:
        x = x ^ mulmod(x, c)
    u = reverse32(x).to(torch.float32) * 2.0 ** -32
    return torch.clamp(u, max=LARGEST_BELOW_ONE)


class Stream:
    """The uniforms of lanes (pixel, sample) under `seed`."""

    def __init__(self, seed, pixel, sample):
        self.seed = int(seed) & M32
        self.pixel = pixel.to(torch.int64) & M32
        self.sample = sample.to(torch.int64) & M32

    def _key(self, *k):
        base = torch.full_like(self.pixel, self.seed)
        return combine(base, self.pixel, *k)

    def u1(self, dim):
        return scrambled_unit(self.sample, self._key(dim))

    def u2(self, dim):
        u = scrambled_unit(self.sample, self._key(dim, 0))
        v = scrambled_unit(reverse32(sobol2(self.sample)), self._key(dim, 1))
        return torch.stack([u, v], -1)


# dimensions of the stream: the film, then eight a bounce from the fifth
DIM_FILM = 0
DIM_BOUNCE0 = 5
DIMS_PER_BOUNCE = 8
SLOT_BSDF2, SLOT_LOBE, SLOT_LIGHT2, SLOT_SELECT, SLOT_RR = 0, 2, 3, 5, 6
SLOT_COMPACT = 8000


def bounce_dim(bounce, slot):
    return DIM_BOUNCE0 + bounce * DIMS_PER_BOUNCE + slot
