"""Reconstruction filters (counterpart of pbrt_tpu/film/filters.py, the
box filter used by the bench)."""
from __future__ import annotations

from typing import NamedTuple

import torch


class Filter(NamedTuple):
    kind: str = "box"
    radius: float = 0.5


def sample_offset(f: Filter, u2):
    """Filter-importance-sampled film offset and its weight."""
    if f.kind == "box":
        off = (u2 - 0.5) * (2.0 * f.radius)
        return off, torch.ones(u2.shape[:-1], dtype=torch.float32, device=u2.device)
    raise NotImplementedError(f"filter {f.kind!r} is not ported yet")
