"""Reconstruction filters (counterpart of pbrt_tpu/film/filters.py): box,
triangle, gaussian, mitchell and lanczos-sinc. `evaluate` gives the
filter's value at an offset; `sample_offset` draws a film offset by filter
importance sampling and returns its weight, so each sample lands in its
own pixel. Box, triangle and gaussian are sampled exactly (weight 1);
mitchell and lanczos, which have negative lobes, by inverting a table of
|f| per axis, with weight sign(f(x)) · sign(f(y)) · (∫|f|)²."""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core.types import PI, f32

KINDS = ("box", "triangle", "gaussian", "mitchell", "lanczos")


class Filter(NamedTuple):
    kind: str = "box"            # box | triangle | gaussian | mitchell | lanczos
    radius: float = 0.5          # the same in x and y
    alpha: float = 2.0           # gaussian
    b: float = 1.0 / 3.0         # mitchell
    c: float = 1.0 / 3.0         # mitchell
    tau: float = 3.0             # lanczos


def evaluate(f: Filter, x, y):
    """The filter's value at offset (x, y) from the sample position."""
    inside = (x.abs() <= f.radius) & (y.abs() <= f.radius)
    if f.kind == "box":
        w = torch.ones_like(x)
    elif f.kind == "triangle":
        w = torch.clamp(f.radius - x.abs(), min=0.0) * torch.clamp(f.radius - y.abs(), min=0.0)
    elif f.kind == "gaussian":
        e = f32(np.float32(np.exp(-f.alpha * f.radius * f.radius)))
        g = lambda d: torch.clamp(torch.exp(-f.alpha * d * d) - e, min=0.0)  # noqa: E731
        w = g(x) * g(y)
    elif f.kind == "mitchell":
        w = _mitchell_1d(f, x / f.radius) * _mitchell_1d(f, y / f.radius)
    elif f.kind == "lanczos":
        w = _windowed_sinc(f, x) * _windowed_sinc(f, y)
    else:
        raise ValueError(f"filter {f.kind!r}: expected one of {KINDS}")
    return torch.where(inside, w, 0.0)


def _mitchell_1d(f: Filter, x):
    """Mitchell–Netravali on offsets normalised to [-1, 1]."""
    x = (2.0 * x).abs()
    b, c = f.b, f.c
    x2 = x * x
    x3 = x2 * x
    big = ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
           + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) * (1.0 / 6.0)
    small = ((12 - 9 * b - 6 * c) * x3 + (-18 + 12 * b + 6 * c) * x2
             + (6 - 2 * b)) * (1.0 / 6.0)
    return torch.where(x > 1.0, big, small)


def _sinc(x):
    x = x.abs()
    return torch.where(x < 1e-5, 1.0, torch.sin(PI * x) / (PI * x))


def _windowed_sinc(f: Filter, x):
    ax = x.abs()
    return torch.where(ax > f.radius, 0.0, _sinc(ax) * _sinc(ax / f.tau))


def sample_offset(f: Filter, u2):
    """Film offset (..., 2) for uniforms u2 (..., 2), and its weight (...)."""
    ones = torch.ones(u2.shape[:-1], dtype=torch.float32, device=u2.device)
    if f.kind == "box":
        return (u2 - 0.5) * (2.0 * f.radius), ones
    if f.kind == "triangle":
        def tent(u):    # inverse cdf of the 1D tent on [-r, r]
            return torch.where(u < 0.5, f.radius * (torch.sqrt(2.0 * u) - 1.0),
                               f.radius * (1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * u,
                                                                        min=0.0))))
        return torch.stack([tent(u2[..., 0]), tent(u2[..., 1])], -1), ones
    if f.kind == "gaussian":
        # Box–Muller, clipped to the radius
        sigma = f32(np.float32(1.0 / np.sqrt(2.0 * f.alpha)))
        r = torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u2[..., 0], min=f32(1e-10)))) * sigma
        th = 2.0 * PI * u2[..., 1]
        off = torch.stack([r * torch.cos(th), r * torch.sin(th)], -1)
        return torch.clamp(off, -f.radius, f.radius), ones
    if f.kind not in KINDS:
        raise ValueError(f"filter {f.kind!r}: expected one of {KINDS}")
    xs_np, cdf_np, integ = _abs_cdf_table(f)
    xs = torch.tensor(xs_np, device=u2.device)
    cdf = torch.tensor(cdf_np, device=u2.device)

    def inv(u):
        idx = torch.clamp(torch.searchsorted(cdf, u.contiguous()) - 1, 0, len(xs_np) - 2)
        c0, c1 = cdf[idx], cdf[idx + 1]
        t = (u - c0) / torch.clamp(c1 - c0, min=f32(1e-12))
        return xs[idx] + t * (xs[idx + 1] - xs[idx])

    ox, oy = inv(u2[..., 0]), inv(u2[..., 1])
    w1 = evaluate(f, ox, torch.zeros_like(ox))
    w2 = evaluate(f, torch.zeros_like(oy), oy)
    return torch.stack([ox, oy], -1), torch.sign(w1) * torch.sign(w2) * f32(integ ** 2)


@functools.lru_cache(maxsize=None)
def _abs_cdf_table(f: Filter, n=256):
    """(xs (n+1,), normalised cdf of |f| along one axis (n+1,), ∫|f| as a
    float32 value), built once per filter on the host from `evaluate` at
    the n cell midpoints."""
    xs = np.linspace(-f.radius, f.radius, n + 1, dtype=np.float32)
    mid = torch.as_tensor(0.5 * (xs[:-1] + xs[1:]))
    vals = np.abs(evaluate(f, mid, torch.zeros_like(mid)).numpy())
    cdf = np.concatenate([[0.0], np.cumsum(vals)]).astype(np.float32)
    integ = cdf[-1] * (2.0 * f.radius / n)
    cdf /= max(cdf[-1], 1e-12)
    xs.flags.writeable = cdf.flags.writeable = False
    return xs, cdf, float(integ)
