"""Batched 3-vector math over (..., 3) tensors (counterpart of
pbrt_tpu/core/vecmath.py)."""
from __future__ import annotations

import torch

from .types import PI, f32, safe_sqrt


def dot(a, b):
    return (a * b).sum(-1)


def absdot(a, b):
    return dot(a, b).abs()


def cross(a, b):
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], -1)


def length_squared(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length_squared(v))


def normalize(v):
    return v / torch.clamp(length(v), min=f32(1e-20))[..., None]


def face_forward(n, v):
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def reflect(wo, n):
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """Refract wi (pointing away from the surface) about n with relative
    IOR eta = eta_i / eta_t. Returns (ok, wt)."""
    cos_i = dot(n, wi)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    cos_t = safe_sqrt(1.0 - sin2_t)
    return sin2_t < 1.0, eta[..., None] * (-wi) + (eta * cos_i - cos_t)[..., None] * n


def spherical_direction(sin_theta, cos_theta, phi):
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], -1)


def spherical_direction_in_frame(sin_theta, cos_theta, phi, x, y, z):
    return ((sin_theta * torch.cos(phi))[..., None] * x
            + (sin_theta * torch.sin(phi))[..., None] * y + cos_theta[..., None] * z)


def spherical_theta(v):
    return torch.arccos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * PI, p)


def coordinate_system(v1):
    """Orthonormal frame around unit v1 (branch-free Duff et al.)."""
    s = torch.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = torch.stack([1.0 + s * v1[..., 0] * v1[..., 0] * a, s * b,
                      -s * v1[..., 0]], -1)
    v3 = torch.stack([b, s + v1[..., 1] * v1[..., 1] * a, -v1[..., 1]], -1)
    return v2, v3


def to_local(v, t, b, n):
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], -1)


def to_world(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def offset_ray_origin(p, n, d):
    """Spawned-ray origin pushed off the surface along n toward d."""
    eps = f32(1e-4) * torch.clamp(p.abs().amax(-1), min=1.0)
    off = torch.where(dot(d, n) < 0.0, -eps, eps)
    return p + off[..., None] * n


def max_component(v):
    return v.amax(-1)
