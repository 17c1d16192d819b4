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
INV_4PI = f32(1.0 / (4.0 * np.pi))
INV_2PI = f32(0.5 / np.pi)
PI_OVER_2 = f32(np.pi / 2.0)
PI_OVER_4 = f32(np.pi / 4.0)

INF = float("inf")
SHADOW_EPS = f32(1e-4)
RAY_EPS = f32(1e-4)
ONE_MINUS_EPSILON = float(np.nextafter(np.float32(1.0), np.float32(0.0)))


def divisor(c, device):
    """c as a float32 divisor that rounds as true division on every
    device: PyTorch's CUDA kernels multiply by the reciprocal of a host
    scalar divisor, which can differ from the quotient by an ulp; a
    tensor on the device keeps the division."""
    if torch.device(device).type == "cpu":
        return float(c)
    return torch.full((), float(c), dtype=torch.float32, device=device)


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def find_interval(cdf, x):
    """Index i with cdf[..., i] <= x < cdf[..., i+1], clamped to a valid
    interval: the count of cdf entries <= x, less one, as the JAX package
    counts it. cdf is sorted (a cumsum): one (M,) cdf shared by every x, or
    one per lane (..., M) for x (...,)."""
    n = cdf.shape[-1]
    idx = torch.searchsorted(cdf, x[..., None].contiguous(), right=True)[..., 0] - 1
    return torch.clamp(idx, 0, n - 2)


def safe_div(a, b, out=0.0):
    """a / b, with `out` where b == 0."""
    return torch.where(b != 0.0, a / torch.where(b != 0.0, b, 1.0), out)


def quadratic(a, b, c):
    """Stable quadratic solve: (has_solution, t0, t1) with t0 <= t1."""
    disc = b * b - 4.0 * a * c
    sqrt_disc = safe_sqrt(disc)
    q = torch.where(b < 0.0, -0.5 * (b - sqrt_disc), -0.5 * (b + sqrt_disc))
    t0 = safe_div(q, a, out=INF)
    t1 = safe_div(c, q, out=INF)
    return disc >= 0.0, torch.minimum(t0, t1), torch.maximum(t0, t1)
