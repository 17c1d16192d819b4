"""4x4 transforms (counterpart of pbrt_tpu/core/transform.py, the parts
the perspective camera uses). Matrices are built on the host in float64
numpy and applied as float32 tensors."""
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
