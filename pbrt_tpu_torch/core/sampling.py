"""Monte Carlo warps, the power heuristic and tabulated distributions
(counterpart of pbrt_tpu/core/sampling.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import vecmath as vm
from .types import (INV_2PI, INV_PI, PI, PI_OVER_2, PI_OVER_4, divisor, f32, find_interval,
                    safe_sqrt)


def prefix_sum(x):
    """Inclusive sum along the last axis: a Hillis–Steele scan of
    elementwise float64 adds, rounded once to x's dtype, so the same bits
    on every device and in every run (torch's CUDA cumsum of floats joins
    a long row's tiles in the order they finish, and its rounding changes
    from run to run), and on the CPU those of torch.cumsum, which sums in
    float64 too, but for a rare tie."""
    y, n, k = x.to(torch.float64), x.shape[-1], 1
    while k < n:
        y = torch.cat([y[..., :k], y[..., k:] + y[..., :n - k]], -1)
        k *= 2
    return y.to(x.dtype)


def uniform_sample_hemisphere(u):
    z = u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def uniform_hemisphere_pdf():
    return INV_2PI


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    return vm.spherical_direction(sin_theta, cos_theta, 2.0 * PI * u[..., 1])


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_theta_max, min=f32(1e-9)))


def concentric_sample_disk(u):
    """Shirley–Chiu concentric disk warp, branch-free."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = ox.abs() > oy.abs()
    r = torch.where(use_x, ox, oy)
    ratio_x = torch.where(ox != 0.0, oy / torch.where(ox != 0.0, ox, 1.0), 0.0)
    ratio_y = torch.where(oy != 0.0, ox / torch.where(oy != 0.0, oy, 1.0), 0.0)
    theta = torch.where(use_x, PI_OVER_4 * ratio_x,
                        PI_OVER_2 - PI_OVER_4 * ratio_y)
    p = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)
    return torch.where(zero[..., None], 0.0, p)


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = safe_sqrt(1.0 - d[..., 0] ** 2 - d[..., 1] ** 2)
    return torch.stack([d[..., 0], d[..., 1], z], -1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta * INV_PI


def power_heuristic(nf, f_pdf, ng, g_pdf):
    f = nf * f_pdf
    g = ng * g_pdf
    return (f * f) / torch.clamp(f * f + g * g, min=f32(1e-20))


def _gather(arr, idx):
    if arr.ndim == 1:
        return arr[idx]
    return torch.gather(arr, -1, idx[..., None])[..., 0]


class Distribution1D(NamedTuple):
    """Piecewise-constant pdf over [0,1): func (..., n), cdf (..., n+1),
    func_int (...,)."""
    func: torch.Tensor
    cdf: torch.Tensor
    func_int: torch.Tensor

    @property
    def count(self):
        return self.func.shape[-1]

    @staticmethod
    def build(func):
        func = torch.clamp(func.to(torch.float32), min=0.0)
        n = func.shape[-1]
        n_div = divisor(n, func.device)
        cdf = prefix_sum(func) / n_div
        func_int = cdf[..., -1]
        safe_int = torch.where(func_int > 0.0, func_int, 1.0)
        ramp = torch.arange(1, n + 1, dtype=torch.float32, device=func.device) / n_div
        cdf = torch.where(func_int[..., None] > 0.0, cdf / safe_int[..., None],
                          ramp)
        cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
        return Distribution1D(func, cdf, func_int)

    def sample_continuous(self, u):
        off = find_interval(self.cdf, u)
        c0 = _gather(self.cdf, off)
        c1 = _gather(self.cdf, off + 1)
        f = _gather(self.func, off)
        du = u - c0
        denom = c1 - c0
        du = torch.where(denom > 0.0, du / torch.where(denom > 0.0, denom, 1.0), du)
        pdf = torch.where(self.func_int > 0.0,
                          f / torch.clamp(self.func_int, min=f32(1e-20)), 0.0)
        return (off.to(torch.float32) + du) / self.count, pdf, off

    def sample_discrete(self, u):
        """Returns (offset, pmf, u remapped into the picked interval)."""
        off = find_interval(self.cdf, u)
        c0 = _gather(self.cdf, off)
        c1 = _gather(self.cdf, off + 1)
        f = _gather(self.func, off)
        pmf = torch.where(self.func_int > 0.0,
                          f / (torch.clamp(self.func_int, min=f32(1e-20)) * self.count), 0.0)
        return off, pmf, (u - c0) / torch.clamp(c1 - c0, min=f32(1e-20))

    def discrete_pdf(self, index):
        return _gather(self.func, index) / (torch.clamp(self.func_int, min=f32(1e-20))
                                            * self.count)


class Distribution2D(NamedTuple):
    """Product distribution over a (ny, nx) grid: a conditional
    Distribution1D per row, a marginal over the rows."""
    conditional: Distribution1D
    marginal: Distribution1D

    @staticmethod
    def build(func):
        conditional = Distribution1D.build(func.to(torch.float32))
        return Distribution2D(conditional, Distribution1D.build(conditional.func_int))

    def sample_continuous(self, u):
        """u (..., 2) → (point (..., 2) in [0,1)^2 as (u, v), pdf)."""
        d1, pdf1, iy = self.marginal.sample_continuous(u[..., 1])
        c = self.conditional
        row = Distribution1D(c.func[iy], c.cdf[iy], c.func_int[iy])
        d0, pdf0, _ = row.sample_continuous(u[..., 0])
        return torch.stack([d0, d1], -1), pdf0 * pdf1

    def pdf(self, p):
        ny, nx = self.conditional.func.shape
        xi = torch.clamp((p[..., 0] * nx).to(torch.int64), 0, nx - 1)
        yi = torch.clamp((p[..., 1] * ny).to(torch.int64), 0, ny - 1)
        return self.conditional.func[yi, xi] / torch.clamp(self.marginal.func_int,
                                                            min=f32(1e-20))
