"""Catmull–Rom splines and Fourier series (counterpart of
pbrt_tpu/core/interpolation.py): the spline weights, 1-D interpolation,
the spline's CDF, 2-D conditional sampling and the cosine series. The
tabulated BSSRDF and the Fourier BSDF use them."""
from __future__ import annotations

import torch

from .types import f32, find_interval


def catmull_rom_weights(nodes, x):
    """(offset i, w0..w3): the spline weights at x over the sorted 1-D
    `nodes`, the four taps at i-1 .. i+2."""
    n = nodes.shape[0]
    i = find_interval(nodes, x)
    x0 = nodes[i]
    x1 = nodes[i + 1]
    t = (x - x0) / torch.clamp(x1 - x0, min=f32(1e-12))
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2

    has_prev = i > 0
    x_1 = nodes[torch.clamp(i - 1, min=0)]
    w0p = (t3 - 2.0 * t2 + t) * (x1 - x0) / torch.clamp(x1 - x_1, min=f32(1e-12))
    w0n = t3 - 2.0 * t2 + t
    w0 = torch.where(has_prev, -w0p, 0.0)
    w1 = torch.where(has_prev, w1, w1 - w0n)
    w2 = w2 + torch.where(has_prev, w0p, w0n)

    has_next = i + 2 < n
    x2 = nodes[torch.clamp(i + 2, max=n - 1)]
    w3p = (t3 - t2) * (x1 - x0) / torch.clamp(x2 - x0, min=f32(1e-12))
    w3n = t3 - t2
    w3 = torch.where(has_next, w3p, 0.0)
    w1 = w1 - torch.where(has_next, w3p, w3n)
    w2 = torch.where(has_next, w2, w2 + w3n)
    return i, w0, w1, w2, w3


def catmull_rom(nodes, values, x):
    """Spline interpolation of `values` over `nodes` at x."""
    i, w0, w1, w2, w3 = catmull_rom_weights(nodes, x)
    n = nodes.shape[0]

    def v(j):
        return values[torch.clamp(j, 0, n - 1)]

    return w0 * v(i - 1) + w1 * v(i) + w2 * v(i + 1) + w3 * v(i + 2)


def integrate_catmull_rom(nodes, values):
    """The spline's CDF over nodes: (cdf (n,), total)."""
    widths = nodes[1:] - nodes[:-1]
    v0 = values[:-1]
    v1 = values[1:]
    d_prev = torch.cat([values[1:2] - values[0:1], (values[2:] - values[:-2]) * 0.5])
    d_next = torch.cat([(values[2:] - values[:-2]) * 0.5, values[-1:] - values[-2:-1]])
    seg = widths * ((v0 + v1) * 0.5 + (d_prev - d_next) / 12.0)
    cdf = torch.cat([torch.zeros(1, dtype=values.dtype, device=values.device),
                     torch.cumsum(seg, 0)])
    return cdf, cdf[-1]


def sample_catmull_rom_2d(nodes1, nodes2, values, cdf, alpha, u):
    """Sample the conditional row the spline over nodes1 selects at alpha,
    linear inside the chosen segment. values, cdf: (n1, n2). Returns
    (x, pdf)."""
    i, w0, w1, w2, w3 = catmull_rom_weights(nodes1, alpha)
    n1 = nodes1.shape[0]

    def row(j):
        jc = torch.clamp(j, 0, n1 - 1)
        return values[jc], cdf[jc]

    v_m1, c_m1 = row(i - 1)
    v_0, c_0 = row(i)
    v_1, c_1 = row(i + 1)
    v_2, c_2 = row(i + 2)
    vals = w0[..., None] * v_m1 + w1[..., None] * v_0 + w2[..., None] * v_1 + w3[..., None] * v_2
    cdfs = w0[..., None] * c_m1 + w1[..., None] * c_0 + w2[..., None] * c_1 + w3[..., None] * c_2
    total = cdfs[..., -1]
    target = u * torch.clamp(total, min=f32(1e-12))
    # the weighted rows need not be sorted: count the entries <= target,
    # as the JAX package does (a row is the spline's n2 nodes long)
    seg = torch.clamp((cdfs <= target[..., None]).sum(-1) - 1, 0, cdfs.shape[-1] - 2)
    c0 = torch.gather(cdfs, -1, seg[..., None])[..., 0]
    c1 = torch.gather(cdfs, -1, seg[..., None] + 1)[..., 0]
    f0 = torch.gather(vals, -1, seg[..., None])[..., 0]
    x0 = nodes2[seg]
    x1 = nodes2[seg + 1]
    t = (target - c0) / torch.clamp(c1 - c0, min=f32(1e-12))
    x = x0 + t * (x1 - x0)
    pdf = torch.clamp(f0, min=0.0) / torch.clamp(total, min=f32(1e-12))
    return x, pdf


def fourier(a, cos_phi, m):
    """Σ a_k cos(kφ) for k < m by the Chebyshev recurrence. a: (..., K);
    m: the active order count (an int or a tensor broadcast to cos_phi)."""
    value = torch.zeros_like(cos_phi)
    cos_km1 = cos_phi
    cos_k = torch.ones_like(cos_phi)
    for k in range(a.shape[-1]):
        term = a[..., k] * cos_k
        if torch.is_tensor(m):
            value = value + torch.where(k < m, term, 0.0)
        elif k < m:
            value = value + term
        cos_k1 = 2.0 * cos_phi * cos_k - cos_km1
        cos_km1 = cos_k
        cos_k = cos_k1
    return value
