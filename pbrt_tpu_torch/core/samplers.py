"""Stateless samplers (counterpart of pbrt_tpu/core/samplers.py):
u = sample(cfg, pixel_id, sample_idx, dim), pixel_id and sample_idx
integer tensors, dim a Python int.

  random      PCG-hash uniform
  stratified  jittered strata, a per-(pixel, dim) stratum permutation
  zerotwo     Owen-scrambled (0,2)-sequence, Sobol' dimensions 0/1
  maxmin      the max-min-distance net for the film 2D, (0,2) elsewhere
  halton      radical inverse with hashed per-pixel digit rotations
  sobol       Owen-scrambled Sobol' over 160 dimensions

Every integer stream equals the JAX package's bit for bit, on the CPU
and on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import trace
from . import lowdiscrepancy as ld
from .rng import M32, hash_combine, mul32, uniform_float
from .types import ONE_MINUS_EPSILON, divisor

KINDS = ("random", "stratified", "zerotwo", "maxmin", "halton", "sobol")
PERM_ROUNDS = 8        # mix rounds of the cycle walk between checks for stragglers


class SamplerConfig(NamedTuple):
    kind: str = "random"
    spp: int = 16
    seed: int = 0
    jitter: bool = True


def _ids(pixel_id, sample_idx):
    pixel_id = pixel_id.to(torch.int64) & M32
    sample_idx = torch.as_tensor(sample_idx, device=pixel_id.device)
    sample_idx = torch.broadcast_to(sample_idx.to(torch.int64) & M32, pixel_id.shape)
    return pixel_id, sample_idx


def _kensler_mix(x, p, w):
    """One round of Kensler's hash permutation network, masked to the
    power-of-two window w + 1 (bijective on [0, w])."""
    x = x ^ p
    x = mul32(x, 0xE170893D)
    x = x ^ (p >> 16)
    x = x ^ ((x & w) >> 4)
    x = x ^ (p >> 8)
    x = mul32(x, 0x0929EB3F)
    x = x ^ (p >> 23)
    x = x ^ ((x & w) >> 1)
    x = (x * (1 | (p >> 27))) & M32
    x = mul32(x, 0x6935FA69)
    x = x ^ ((x & w) >> 11)
    x = mul32(x, 0x74DCB303)
    x = x ^ ((x & w) >> 2)
    x = mul32(x, 0x9E501CC3)
    x = x ^ ((x & w) >> 2)
    x = mul32(x, 0xC860A3DF)
    x = x & w
    return x ^ (x >> 5)


def _perm_element(i, n: int, seed):
    """Element i of a hashed permutation of [0, n): Kensler's cycle walk.
    The walk runs PERM_ROUNDS rounds between checks, so the card syncs
    once per check, not once per round; a lane already inside [0, n)
    keeps its value, so the extra rounds change nothing."""
    if n <= 1:
        return torch.zeros_like(i)
    w = 1
    while w < n:
        w <<= 1
    w -= 1
    x = _kensler_mix(i, seed, w)
    while True:
        for _ in range(PERM_ROUNDS):
            x = torch.where(x >= n, _kensler_mix(x, seed, w), x)
        if not bool((x >= n).any()):
            break
    return ((x + seed) & M32) % n


def _stratified_1d(cfg, pixel_id, sample_idx, dim):
    stratum = _perm_element(sample_idx, cfg.spp, hash_combine(cfg.seed, pixel_id, dim))
    j = uniform_float(cfg.seed, pixel_id, sample_idx, dim) if cfg.jitter else 0.5
    u = (stratum.to(torch.float32) + j) / divisor(cfg.spp, pixel_id.device)
    return torch.clamp(u, max=ONE_MINUS_EPSILON)


@trace.spanned("sampler.sample_1d")
def sample_1d(cfg: SamplerConfig, pixel_id, sample_idx, dim: int):
    """One U[0,1) per lane."""
    pixel_id, sample_idx = _ids(pixel_id, sample_idx)
    if cfg.kind == "random":
        return uniform_float(cfg.seed, pixel_id, sample_idx, dim)
    if cfg.kind == "stratified":
        return _stratified_1d(cfg, pixel_id, sample_idx, dim)
    if cfg.kind in ("zerotwo", "maxmin"):
        return ld.sobol_sample(sample_idx, 0, hash_combine(cfg.seed, pixel_id, dim))
    if cfg.kind == "sobol":
        return ld.sobol_sample(sample_idx, min(dim, ld.NUM_SOBOL_DIMENSIONS - 1),
                               hash_combine(cfg.seed, pixel_id, dim))
    if cfg.kind == "halton":
        return ld.scrambled_radical_inverse(min(dim, 999), sample_idx,
                                            hash_combine(cfg.seed, pixel_id))
    raise ValueError(f"unknown sampler kind {cfg.kind!r}")


@trace.spanned("sampler.sample_2d")
def sample_2d(cfg: SamplerConfig, pixel_id, sample_idx, dim: int):
    """Two U[0,1) per lane, shape (..., 2), from dims (dim, dim+1)."""
    pixel_id, sample_idx = _ids(pixel_id, sample_idx)
    if cfg.kind == "stratified":
        # an nx × ny grid of strata for true 2D stratification
        nx = int(np.floor(np.sqrt(cfg.spp)))
        while cfg.spp % nx:
            nx -= 1
        ny = cfg.spp // nx
        stratum = _perm_element(sample_idx, cfg.spp, hash_combine(cfg.seed, pixel_id, dim))
        sx = (stratum % nx).to(torch.float32)
        sy = torch.div(stratum, nx, rounding_mode="floor").to(torch.float32)
        if cfg.jitter:
            jx = uniform_float(cfg.seed, pixel_id, sample_idx, dim)
            jy = uniform_float(cfg.seed, pixel_id, sample_idx, dim + 1)
        else:
            jx = jy = 0.5
        dev = pixel_id.device
        u = torch.clamp((sx + jx) / divisor(nx, dev), max=ONE_MINUS_EPSILON)
        v = torch.clamp((sy + jy) / divisor(ny, dev), max=ONE_MINUS_EPSILON)
        return torch.stack([u, v], -1)
    if cfg.kind in ("zerotwo", "maxmin"):
        scr0 = hash_combine(cfg.seed, pixel_id, dim, 0)
        scr1 = hash_combine(cfg.seed, pixel_id, dim, 1)
        if cfg.kind == "maxmin" and dim == DIM_FILM and cfg.spp & (cfg.spp - 1) == 0 \
                and 2 <= cfg.spp <= 1024:
            # the film plane takes the max-min-distance net
            return ld.maxmin_sample2(sample_idx, int(np.log2(cfg.spp)), scr0, scr1)
        # (0,2)-net: Sobol' dims 0 and 1 share the index, one Owen
        # scramble pair per (pixel, dim slot)
        u = ld.sobol_sample(sample_idx, 0, scr0)
        v = ld.sobol_sample(sample_idx, 1, scr1)
        return torch.stack([u, v], -1)
    u = sample_1d(cfg, pixel_id, sample_idx, dim)
    v = sample_1d(cfg, pixel_id, sample_idx, dim + 1)
    return torch.stack([u, v], -1)


DIM_FILM = 0
DIM_LENS = 2
DIM_TIME = 4
DIM_BOUNCE0 = 5
DIMS_PER_BOUNCE = 8


def bounce_dim(bounce: int, slot: int) -> int:
    return DIM_BOUNCE0 + bounce * DIMS_PER_BOUNCE + slot
