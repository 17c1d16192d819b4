"""Separable BSSRDF with a tabulated beam-diffusion profile (counterpart of
pbrt_tpu/shade/bssrdf.py): the Fresnel moments, the (ρ, r) profile table
filled on the host in numpy by photon beam diffusion, the radial profile
Sr, its inverse-CDF radius sample, and the directional term Sw. The
probe rays that find the exit point are integrate/path_sss.py."""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import PI, f32, find_interval
from .bxdf import fresnel_dielectric


def _powers(eta):
    """eta², eta³, eta⁴, eta⁵ by square-and-multiply, rounded as the JAX
    package's integer powers round them."""
    eta2 = eta * eta
    eta4 = eta2 * eta2
    return eta2, eta * eta2, eta4, eta * eta4


def fresnel_moment1(eta):
    """∫ Fr(η, cos θ) cos θ sin θ dθ, the polynomial fit."""
    eta2, eta3, eta4, eta5 = _powers(eta)
    lo = f32(0.45966) - f32(1.73965) * eta + f32(3.37668) * eta2 - f32(3.904945) * eta3 \
        + f32(2.49277) * eta4 - f32(0.68441) * eta5
    hi = f32(-4.61686) + f32(11.1136) * eta - f32(10.4646) * eta2 + f32(5.11455) * eta3 \
        - f32(1.27198) * eta4 + f32(0.12746) * eta5
    return torch.where(eta < 1.0, lo, hi)


def fresnel_moment2(eta):
    eta2, eta3, eta4, eta5 = _powers(eta)
    lo = f32(0.27614) - f32(0.87350) * eta + f32(1.12077) * eta2 - f32(0.65095) * eta3 \
        + f32(0.07883) * eta4 + f32(0.04860) * eta5
    hi = f32(-547.033) + f32(45.3087) / eta3 - f32(218.725) / eta2 + f32(458.843) / eta \
        + f32(404.557) * eta - f32(189.519) * eta2 + f32(54.9327) * eta3 - f32(9.00603) * eta4 \
        + f32(0.63942) * eta5
    return torch.where(eta < 1.0, lo, hi)


def _moments(eta):
    e = torch.tensor(eta, dtype=torch.float32)
    return float(fresnel_moment1(e)), float(fresnel_moment2(e))


def _midpoints(n_samples):
    return (np.arange(n_samples) + 0.5) / n_samples


def beam_diffusion_ms(sigma_s, sigma_a, g, eta, r, n_samples=100, moments=None):
    """Multiple-scattering profile by photon beam diffusion, on the host
    (float64, the n_samples depths at once)."""
    sigmap_s = sigma_s * (1 - g)
    sigmap_t = sigma_a + sigmap_s
    if sigmap_t <= 0:
        return 0.0
    rhop = sigmap_s / sigmap_t
    d_g = (2 * sigma_a + sigmap_s) / (3 * sigmap_t ** 2)
    sigma_tr = np.sqrt(sigma_a / d_g)
    fm1, fm2 = moments if moments is not None else _moments(eta)
    ze = -2 * d_g * (1 + 3 * fm2) / (1 - 2 * fm1)
    c_phi = 0.25 * (1 - 2 * fm1)
    c_e = 0.5 * (1 - 3 * fm2)
    zr = -np.log(1 - _midpoints(n_samples)) / sigmap_t
    zv = -zr + 2 * ze
    dr = np.sqrt(r * r + zr * zr)
    dv = np.sqrt(r * r + zv * zv)
    phi_d = (np.exp(-sigma_tr * dr) / dr - np.exp(-sigma_tr * dv) / dv) / (4 * np.pi * d_g)
    edn = (zr * (1 + sigma_tr * dr) * np.exp(-sigma_tr * dr) / dr ** 3
           - zv * (1 + sigma_tr * dv) * np.exp(-sigma_tr * dv) / dv ** 3) / (4 * np.pi)
    kappa = 1 - np.exp(-2 * sigmap_t * (dr + zr))
    ed = rhop * rhop * np.exp(-sigma_a * zr) * kappa * (c_phi * phi_d + c_e * edn)
    return max(float(np.sum(ed)) / n_samples, 0.0)


def _fr_dielectric_np(ci, ei, et):
    """Dielectric Fresnel reflectance of cosines ci (an array)."""
    ci = np.abs(ci)
    si = np.sqrt(np.maximum(0.0, 1 - ci * ci))
    st = ei / et * si
    ct = np.sqrt(np.maximum(0.0, 1 - st * st))
    rpar = (et * ci - ei * ct) / np.maximum(et * ci + ei * ct, 1e-12)
    rperp = (ei * ci - et * ct) / np.maximum(ei * ci + et * ct, 1e-12)
    return np.where(st >= 1, 1.0, 0.5 * (rpar ** 2 + rperp ** 2))


def beam_diffusion_ss(sigma_s, sigma_a, g, eta, r, n_samples=100):
    """Single-scattering term, on the host (the n_samples depths at once)."""
    sigma_t = sigma_a + sigma_s
    if sigma_t <= 0:
        return 0.0
    rho = sigma_s / sigma_t
    t_crit = r * np.sqrt(max(eta * eta - 1.0, 0.0))
    ti = t_crit - np.log(1 - _midpoints(n_samples)) / sigma_t
    d = np.sqrt(r * r + ti * ti)
    cos_theta_o = ti / np.maximum(d, 1e-12)
    denom = 1 + g * g + 2 * g * -cos_theta_o
    phase = (1 - g * g) / (4 * np.pi * denom * np.sqrt(np.maximum(denom, 1e-12)))
    fr = _fr_dielectric_np(cos_theta_o, 1.0, eta)
    ess = rho * np.exp(-sigma_t * (d + t_crit)) / (d * d) * phase * (1 - fr) \
        * np.abs(cos_theta_o)
    return max(float(np.sum(ess)) / n_samples, 0.0)


@dataclass
class BSSRDFTable:
    rho_samples: torch.Tensor     # (n_rho,)
    radius_samples: torch.Tensor  # (n_r,)
    profile: torch.Tensor         # (n_rho, n_r) r·Sr(ρ, r), unitless radius
    profile_cdf: torch.Tensor     # (n_rho, n_r)
    rho_eff: torch.Tensor         # (n_rho,) effective albedo


FIELDS = ("rho_samples", "radius_samples", "profile", "profile_cdf", "rho_eff")


def table_from_numpy(arrs, device):
    return BSSRDFTable(**{k: torch.as_tensor(np.asarray(arrs[k], np.float32), device=device)
                          for k in FIELDS})


@functools.lru_cache(maxsize=8)
def beam_diffusion_table_np(g=0.0, eta=1.33, n_rho=32, n_r=64):
    """The (ρ, r) profile table as numpy float32 arrays (a dict of FIELDS,
    kept per argument set: read it, do not write it)."""
    moments = _moments(eta)
    rho = 1.0 - np.exp(-8.0 * np.arange(n_rho) / (n_rho - 1))
    radius = np.zeros(n_r)
    radius[1:] = 0.0025 * 1.2 ** np.arange(n_r - 1)
    profile = np.zeros((n_rho, n_r))
    rho_eff = np.zeros(n_rho)
    cdfs = np.zeros_like(profile)
    for i, rh in enumerate(rho):
        for j, r in enumerate(radius):
            rr = max(r, 1e-6)
            profile[i, j] = 2 * np.pi * rr * (
                beam_diffusion_ms(rh, 1 - rh, g, eta, rr, moments=moments)
                + beam_diffusion_ss(rh, 1 - rh, g, eta, rr))
        seg = 0.5 * (profile[i, 1:] + profile[i, :-1]) * np.diff(radius)
        c = np.concatenate([[0.0], np.cumsum(seg)])
        rho_eff[i] = c[-1]
        cdfs[i] = c / max(c[-1], 1e-12)
    return {k: np.asarray(v, np.float32) for k, v in
            zip(FIELDS, (rho, radius, profile, cdfs, rho_eff))}


def _rho_index(table, rho_c):
    n_rho = table.rho_samples.shape[0]
    return torch.clamp(torch.searchsorted(table.rho_samples, rho_c.contiguous()) - 1,
                       0, n_rho - 2)


def _r_index(table, r_c):
    n_r = table.radius_samples.shape[0]
    return torch.clamp(torch.searchsorted(table.radius_samples, r_c.contiguous()) - 1,
                       0, n_r - 2)


def sr(table: BSSRDFTable, sigma_t, rho, r):
    """Radial profile Sr(r) per channel, (..., 3): bilinear in (ρ, r·σt)
    of the unitless table, over 2π·r_optical, times σt²."""
    r_opt = r[..., None] * sigma_t
    rs, prof = table.radius_samples, table.profile
    out = []
    for c in range(3):
        rho_c, r_c = rho[..., c], r_opt[..., c]
        i_rho = _rho_index(table, rho_c)
        f_rho = (rho_c - table.rho_samples[i_rho]) / torch.clamp(
            table.rho_samples[i_rho + 1] - table.rho_samples[i_rho], min=f32(1e-9))
        i_r = _r_index(table, r_c)
        f_r = (r_c - rs[i_r]) / torch.clamp(rs[i_r + 1] - rs[i_r], min=f32(1e-9))
        v = (1 - f_rho) * ((1 - f_r) * prof[i_rho, i_r] + f_r * prof[i_rho, i_r + 1]) \
            + f_rho * ((1 - f_r) * prof[i_rho + 1, i_r] + f_r * prof[i_rho + 1, i_r + 1])
        v = torch.clamp(v, min=0.0)
        out.append(v * sigma_t[..., c] * sigma_t[..., c] / torch.clamp(
            2.0 * PI * torch.clamp(r_c, min=f32(1e-6)), min=f32(1e-9)))
    return torch.stack(out, -1)


def sample_radius(table: BSSRDFTable, sigma_t_c, rho_c, u):
    """Inverse-CDF radius of one channel's profile. Returns (r, pdf_r)."""
    i_rho = _rho_index(table, rho_c)
    cdf = table.profile_cdf[i_rho]
    seg = find_interval(cdf, u)
    c0 = torch.gather(cdf, -1, seg[..., None])[..., 0]
    c1 = torch.gather(cdf, -1, seg[..., None] + 1)[..., 0]
    t = (u - c0) / torch.clamp(c1 - c0, min=f32(1e-9))
    r0 = table.radius_samples[seg]
    r1 = table.radius_samples[seg + 1]
    r_opt = r0 + t * (r1 - r0)
    p0 = torch.gather(table.profile[i_rho], -1, seg[..., None])[..., 0]
    pdf_opt = p0 / torch.clamp(table.rho_eff[i_rho], min=f32(1e-9))
    return r_opt / torch.clamp(sigma_t_c, min=f32(1e-9)), pdf_opt * sigma_t_c


def sw(eta, cos_theta):
    """Directional term Sw of the separable BSSRDF."""
    c = 1.0 - 2.0 * fresnel_moment1(1.0 / eta)
    fr = fresnel_dielectric(cos_theta, torch.ones_like(eta), eta)
    return (1.0 - fr) / (c * PI)
