"""4x4 transforms (counterpart of pbrt_tpu/core/transform.py but its
quaternions and AnimatedTransform, which nothing calls: instances keep
their own (w, x, y, z) quaternions and slerp in geom/instances.py).
Matrices are built on the host in numpy and applied as float32 tensors:
the camera matrices in float64, the rotations in float32 as the JAX
package builds them."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Transform(NamedTuple):
    m: torch.Tensor       # (4, 4) float32
    m_inv: torch.Tensor   # (4, 4) float32

    def inverse(self):
        return Transform(self.m_inv, self.m)

    def apply_point(self, p):
        m = self.m
        r = (p[..., None, :] * m[:3, :3]).sum(-1) + m[:3, 3]
        w = (p * m[3, :3]).sum(-1) + m[3, 3]
        return r / w[..., None]

    def apply_vector(self, v):
        return (v[..., None, :] * self.m[:3, :3]).sum(-1)


def from_numpy(m, device, m_inv=None):
    """Transform from a host matrix (float64 preferred); the inverse is
    taken in float64 unless given."""
    m = np.asarray(m, np.float64)
    m_inv = np.linalg.inv(m) if m_inv is None else np.asarray(m_inv, np.float64)
    return Transform(torch.tensor(m, dtype=torch.float32, device=device),
                     torch.tensor(m_inv, dtype=torch.float32, device=device))


def from_matrix(m, device):
    """Transform of the float32 matrix m (the JAX package's from_matrix)."""
    return from_numpy(np.asarray(m, np.float32), device)


def _sin_cos(theta_deg):
    """float32 sin and cos of theta (degrees), through the float32 radians
    the JAX package computes (theta · float32(π/180)); each correctly
    rounded, where XLA's are within an ulp of it."""
    t = np.float64(np.float32(theta_deg) * np.float32(np.pi / 180.0))
    return np.float32(np.sin(t)), np.float32(np.cos(t))


def rotate_x_np(theta_deg):
    s, c = _sin_cos(theta_deg)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, -s, s, c
    return m


def rotate_y_np(theta_deg):
    s, c = _sin_cos(theta_deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def rotate_z_np(theta_deg):
    s, c = _sin_cos(theta_deg)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, -s, s, c
    return m


def rotate_np(theta_deg, axis):
    """float32 rotation by theta (degrees) about `axis`, the JAX package's
    float32 arithmetic term for term (its inverse is the transpose)."""
    a = np.asarray(axis, np.float32)
    a = a / np.maximum(np.sqrt(np.sum(a * a)), np.float32(1e-20))
    x, y, z = a
    s, c = _sin_cos(theta_deg)
    one_c = np.float32(1.0) - c
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = [[c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s],
                 [x * y * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s],
                 [x * z * one_c - y * s, y * z * one_c + x * s, c + z * z * one_c]]
    return m


def orthographic_np(z_near, z_far):
    m = np.eye(4)
    m[2, 2] = 1.0 / (z_far - z_near)
    m[2, 3] = -z_near / (z_far - z_near)
    return m


def look_at_np(pos, look, up):
    """camera→world matrix (float64), PBRT's LookAt inverse."""
    pos, look, up = (np.asarray(a, np.float64) for a in (pos, look, up))
    dir_ = look - pos
    dir_ = dir_ / np.linalg.norm(dir_)
    up = up / np.linalg.norm(up)
    right = np.cross(up, dir_)
    right = right / np.linalg.norm(right)
    new_up = np.cross(dir_, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = new_up
    c2w[:3, 2] = dir_
    c2w[:3, 3] = pos
    return c2w


def perspective_np(fov_deg, n, f):
    persp = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                      [0, 0, f / (f - n), -f * n / (f - n)], [0, 0, 1, 0]],
                     np.float64)
    inv_tan = 1.0 / np.tan(np.deg2rad(fov_deg) / 2.0)
    return np.diag([inv_tan, inv_tan, 1.0, 1.0]) @ persp


def scale_np(s):
    return np.diag([s[0], s[1], s[2], 1.0])


def translate_np(t):
    m = np.eye(4)
    m[:3, 3] = t
    return m

