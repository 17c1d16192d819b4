"""The Fourier BSDF: a measured BSDF as azimuthal Fourier series
(counterpart of pbrt_tpu/shade/fourier.py). f(μi, μo, φ) = Σ a_k cos(kφ),
the coefficients interpolated over the (μi, μo) grid by Catmull–Rom
weights. The ragged coefficient lists of a PBRT-v3 "SCATFUN" v1 file are
made dense: (n, n, 3, m_max) blocks, m_max capped."""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np
import torch

from ..core.interpolation import catmull_rom_weights, fourier
from ..core.sampling import cosine_sample_hemisphere
from ..core.types import INV_PI, f32


@dataclass
class FourierTable:
    mu: torch.Tensor     # (n,) zenith cosines, sorted
    a: torch.Tensor      # (n, n, 3, m_max) coefficients of channels Y, R, B
    m: torch.Tensor      # (n, n) int64 active orders
    eta: float = 1.0
    m_max: int = 1


def table_from_numpy(arrs, device):
    """FourierTable from numpy: mu, a, m, eta, m_max."""
    t = lambda x, dt=torch.float32: torch.as_tensor(np.asarray(x), device=device).to(dt)  # noqa: E731
    return FourierTable(t(arrs["mu"]), t(arrs["a"]), t(arrs["m"], torch.int64),
                        float(arrs["eta"]), int(arrs["m_max"]))


def load_bsdf_file(path, m_cap=64, device="cpu"):
    """A PBRT-v3 .bsdf ("SCATFUN" v1) file → FourierTable."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:7] != b"SCATFUN":
        raise ValueError("not a SCATFUN file")
    if data[7] != 1:
        raise ValueError(f"unsupported SCATFUN version {data[7]}")
    (_flags, n_mu, n_coeffs, m_max, n_channels, _n_bases, _u0, _u1,
     eta, _r0, _r1, _r2, _r3, _r4) = struct.unpack("<8i6f", data[8:8 + 56])
    off = 64
    mu = np.frombuffer(data, "<f4", n_mu, off)
    off += 4 * n_mu + 4 * n_mu * n_mu        # mu, then the cdf (not used)
    offlen = np.frombuffer(data, "<i4", 2 * n_mu * n_mu, off).reshape(-1, 2)
    off += 8 * n_mu * n_mu
    coeffs = np.frombuffer(data, "<f4", n_coeffs, off)
    m_max = min(m_max, m_cap)
    a = np.zeros((n_mu, n_mu, 3, m_max), np.float32)
    m = np.zeros((n_mu, n_mu), np.int32)
    for i in range(n_mu):
        for j in range(n_mu):
            o, ln = offlen[i * n_mu + j]
            per = ln // max(n_channels, 1) if n_channels else 0
            take = min(per, m_max)
            m[i, j] = take
            for c in range(min(n_channels, 3)):
                a[i, j, c, :take] = coeffs[o + c * per:o + c * per + take]
            if n_channels == 1:
                a[i, j, 1] = a[i, j, 0]
                a[i, j, 2] = a[i, j, 0]
    return table_from_numpy(dict(mu=mu, a=a, m=m, eta=float(eta), m_max=m_max), device)


def make_lambertian_table(albedo=(0.5, 0.5, 0.5), n_mu=16, device="cpu"):
    """A constant-profile table, a_0 = ρ/π in channels Y, R and B."""
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    alb = np.asarray(albedo, np.float32)
    y_lum = 0.212671 * alb[0] + 0.715160 * alb[1] + 0.072169 * alb[2]
    a = np.zeros((n_mu, n_mu, 3, 1), np.float32)
    a[:, :, 0, 0] = y_lum * INV_PI
    a[:, :, 1, 0] = alb[0] * INV_PI
    a[:, :, 2, 0] = alb[2] * INV_PI
    return table_from_numpy(dict(mu=mu, a=a, m=np.ones((n_mu, n_mu), np.int32), eta=1.0,
                                 m_max=1), device)


def fourier_f(table: FourierTable, wo, wi):
    """f(wo, wi), (..., 3); μi is the cosine of -wi, as in PBRT."""
    mu_i = torch.clamp(-wi[..., 2], -1.0, 1.0)
    mu_o = torch.clamp(wo[..., 2], -1.0, 1.0)
    sin_i = torch.sqrt(torch.clamp(1.0 - wi[..., 2] ** 2, min=0.0))
    sin_o = torch.sqrt(torch.clamp(1.0 - wo[..., 2] ** 2, min=0.0))
    cos_phi = torch.where((sin_i > f32(1e-8)) & (sin_o > f32(1e-8)),
                          torch.clamp((wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1])
                                      / torch.clamp(sin_i * sin_o, min=f32(1e-8)), -1.0, 1.0),
                          1.0)
    ii, wi0, wi1, wi2, wi3 = catmull_rom_weights(table.mu, mu_i)
    oi, wo0, wo1, wo2, wo3 = catmull_rom_weights(table.mu, mu_o)
    n = table.mu.shape[0]
    acc = torch.zeros(wo.shape[:-1] + (3, table.m_max), dtype=wo.dtype, device=wo.device)
    for di, wgt_i in zip((-1, 0, 1, 2), (wi0, wi1, wi2, wi3)):
        for dj, wgt_o in zip((-1, 0, 1, 2), (wo0, wo1, wo2, wo3)):
            coef = table.a[torch.clamp(ii + di, 0, n - 1), torch.clamp(oi + dj, 0, n - 1)]
            acc = acc + (wgt_i * wgt_o)[..., None, None] * coef
    y, r, b = (torch.clamp(fourier(acc[..., c, :], cos_phi, table.m_max), min=0.0)
               for c in range(3))
    g = f32(1.39829) * y - f32(0.100913) * b - f32(0.297375) * r
    return torch.stack([r, torch.clamp(g, min=0.0), b], -1)


def fourier_sample(table: FourierTable, wo, u2):
    """Cosine-weighted direction on wo's side with the table's f and the
    cosine pdf. Returns (wi, f, pdf)."""
    wi = cosine_sample_hemisphere(u2)
    wi = torch.where((wo[..., 2] < 0.0)[..., None], torch.cat([wi[..., :2], -wi[..., 2:]], -1),
                     wi)
    return wi, fourier_f(table, wo, wi), wi[..., 2].abs() * INV_PI
