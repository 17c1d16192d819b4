"""Numeric constants (counterpart of pbrt_tpu/core/types.py).

Every constant is a Python float that float32 represents exactly, so an
elementwise op with a tensor rounds the same way in PyTorch on the CPU,
in PyTorch on the card and in the CUDA kernels.
"""
from __future__ import annotations

import numpy as np
import torch


def f32(x) -> float:
    """x rounded to the nearest float32, as a Python float."""
    return float(np.float32(x))


PI = f32(np.pi)
INV_PI = f32(1.0 / np.pi)
INV_2PI = f32(0.5 / np.pi)
PI_OVER_2 = f32(np.pi / 2.0)
PI_OVER_4 = f32(np.pi / 4.0)

INF = float("inf")
SHADOW_EPS = f32(1e-4)
RAY_EPS = f32(1e-4)
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def find_interval(cdf, x):
    """Index i with cdf[..., i] <= x < cdf[..., i+1], clamped to a valid
    interval (comparison-sum form, as in the JAX package)."""
    n = cdf.shape[-1]
    idx = (cdf <= x[..., None]).to(torch.int64).sum(-1) - 1
    return torch.clamp(idx, 0, n - 2)
