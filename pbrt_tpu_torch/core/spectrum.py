"""RGB helpers (counterpart of pbrt_tpu/core/spectrum.py: luminance)."""
from __future__ import annotations

from .types import f32

_WR, _WG, _WB = f32(0.212671), f32(0.715160), f32(0.072169)


def luminance(s):
    """y() of an RGB triple."""
    return (s[..., 0] * _WR + s[..., 1] * _WG) + s[..., 2] * _WB
