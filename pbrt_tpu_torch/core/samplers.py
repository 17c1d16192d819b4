"""Stateless samplers, `random` and `zerotwo` (counterpart of
pbrt_tpu/core/samplers.py). u = sample(cfg, pixel_id, sample_idx, dim);
pixel_id and sample_idx are integer tensors, dim a Python int."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import lowdiscrepancy as ld
from .rng import hash_combine, uniform_float

KINDS = ("random", "zerotwo")


class SamplerConfig(NamedTuple):
    kind: str = "random"
    spp: int = 16
    seed: int = 0


def _ids(pixel_id, sample_idx):
    pixel_id = pixel_id.to(torch.int64) & 0xFFFFFFFF
    sample_idx = torch.as_tensor(sample_idx, device=pixel_id.device)
    sample_idx = torch.broadcast_to(sample_idx.to(torch.int64) & 0xFFFFFFFF,
                                    pixel_id.shape)
    return pixel_id, sample_idx


def sample_1d(cfg: SamplerConfig, pixel_id, sample_idx, dim: int):
    """One U[0,1) per lane."""
    pixel_id, sample_idx = _ids(pixel_id, sample_idx)
    if cfg.kind == "random":
        return uniform_float(cfg.seed, pixel_id, sample_idx, dim)
    if cfg.kind == "zerotwo":
        scr = hash_combine(cfg.seed, pixel_id, dim)
        return ld.sobol_sample(sample_idx, 0, scramble_seed=scr)
    raise NotImplementedError(f"sampler kind {cfg.kind!r} is not ported yet")


def sample_2d(cfg: SamplerConfig, pixel_id, sample_idx, dim: int):
    """Two U[0,1) per lane, shape (..., 2), from dims (dim, dim+1)."""
    pixel_id, sample_idx = _ids(pixel_id, sample_idx)
    if cfg.kind == "zerotwo":
        # (0,2)-net: Sobol' dims 0 and 1 share the index, one Owen
        # scramble pair per (pixel, dim slot)
        scr0 = hash_combine(cfg.seed, pixel_id, dim, 0)
        scr1 = hash_combine(cfg.seed, pixel_id, dim, 1)
        u = ld.sobol_sample(sample_idx, 0, scramble_seed=scr0)
        v = ld.sobol_sample(sample_idx, 1, scramble_seed=scr1)
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
