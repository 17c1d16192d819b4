"""BxDF lobes for the bench materials, shading-local frame (counterpart
of pbrt_tpu/shade/bxdf.py): Lambert / Oren–Nayar, and GGX (Trowbridge–
Reitz, visible-normal sampling) with dielectric Fresnel."""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.sampling import cosine_sample_hemisphere
from ..core.types import INV_PI, PI, f32, safe_sqrt


def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return w[..., 2].abs()


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def tan_theta(w):
    c = cos_theta(w)
    return sin_theta(w) / torch.where(c != 0.0, c, f32(1e-8))


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=f32(1e-12))


def cos_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 1.0,
                       torch.clamp(w[..., 0] / torch.clamp(s, min=f32(1e-12)), -1.0, 1.0))


def sin_phi(w):
    s = sin_theta(w)
    return torch.where(s == 0.0, 0.0,
                       torch.clamp(w[..., 1] / torch.clamp(s, min=f32(1e-12)), -1.0, 1.0))


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0.0


def fresnel_dielectric(cos_theta_i, eta_i, eta_t):
    """Unpolarised Fresnel reflectance of a dielectric, both sides."""
    ci = torch.clamp(cos_theta_i, -1.0, 1.0)
    entering = ci > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = ci.abs()
    si = safe_sqrt(1.0 - ci * ci)
    st = ei / et * si
    tir = st >= 1.0
    ct = safe_sqrt(1.0 - st * st)
    r_par = ((et * ci) - (ei * ct)) / torch.clamp((et * ci) + (ei * ct), min=f32(1e-12))
    r_perp = ((ei * ci) - (et * ct)) / torch.clamp((ei * ci) + (et * ct), min=f32(1e-12))
    fr = 0.5 * (r_par * r_par + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def roughness_to_alpha(roughness):
    """PBRT-v3 TrowbridgeReitz roughness remap."""
    x = torch.log(torch.clamp(roughness, min=f32(1e-3)))
    return (f32(1.62142) + f32(0.819955) * x + f32(0.1734) * x * x
            + f32(0.0171201) * x ** 3 + f32(0.000640711) * x ** 4)


def _alpha_clamp(a):
    return torch.clamp(a, min=f32(1e-3))


def ggx_d(ax, ay, wh):
    ax, ay = _alpha_clamp(ax), _alpha_clamp(ay)
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    e = (cos_phi(wh) ** 2 / (ax * ax) + sin_phi(wh) ** 2 / (ay * ay)) * t2
    d = 1.0 / (PI * ax * ay * torch.clamp(c4, min=f32(1e-12))
               * torch.clamp((1.0 + e) ** 2, min=f32(1e-12)))
    return torch.where(torch.isfinite(t2), d, 0.0)


def ggx_lambda(ax, ay, w):
    ax, ay = _alpha_clamp(ax), _alpha_clamp(ay)
    abs_tan = tan_theta(w).abs()
    alpha = torch.sqrt(cos_phi(w) ** 2 * ax * ax + sin_phi(w) ** 2 * ay * ay)
    lam = (-1.0 + torch.sqrt(1.0 + (alpha * abs_tan) ** 2)) / 2.0
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def ggx_g1(ax, ay, w):
    return 1.0 / (1.0 + ggx_lambda(ax, ay, w))


def ggx_g(ax, ay, wo, wi):
    return 1.0 / (1.0 + ggx_lambda(ax, ay, wo) + ggx_lambda(ax, ay, wi))


def ggx_sample_wh(ax, ay, wo, u2):
    """GGX visible-normal sampling (Heitz 2018)."""
    ax, ay = _alpha_clamp(ax), _alpha_clamp(ay)
    flip = wo[..., 2] < 0.0
    w = torch.where(flip[..., None], -wo, wo)
    vh = vm.normalize(torch.stack([ax * w[..., 0], ay * w[..., 1], w[..., 2]], -1))
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1_a = torch.stack([-vh[..., 1], vh[..., 0], torch.zeros_like(lensq)], -1) \
        / torch.sqrt(torch.clamp(lensq, min=f32(1e-12)))[..., None]
    t1_b = torch.zeros_like(vh)
    t1_b[..., 0] = 1.0
    t1 = torch.where(lensq[..., None] > f32(1e-12), t1_a, t1_b)
    t2v = vm.cross(vh, t1)
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * PI * u2[..., 1]
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * safe_sqrt(1.0 - p1 * p1) + s * p2
    p3 = safe_sqrt(1.0 - p1 * p1 - p2 * p2)
    nh = p1[..., None] * t1 + p2[..., None] * t2v + p3[..., None] * vh
    wh = vm.normalize(torch.stack([ax * nh[..., 0], ay * nh[..., 1],
                                   torch.clamp(nh[..., 2], min=f32(1e-6))], -1))
    return torch.where(flip[..., None], -wh, wh)


def ggx_pdf(ax, ay, wo, wh):
    """pdf of ggx_sample_wh w.r.t. the solid angle of wh."""
    return ggx_d(ax, ay, wh) * ggx_g1(ax, ay, wo) * vm.absdot(wo, wh) \
        / torch.clamp(abs_cos_theta(wo), min=f32(1e-8))


def lambertian_f(r, wo, wi):
    return torch.where(same_hemisphere(wo, wi)[..., None], r * INV_PI, 0.0)


def lambertian_sample(wo, u2):
    """Cosine-weighted direction on wo's side. Returns (wi, pdf)."""
    wi = cosine_sample_hemisphere(u2)
    flipped = torch.cat([wi[..., :2], -wi[..., 2:]], -1)
    wi = torch.where((wo[..., 2] < 0.0)[..., None], flipped, wi)
    return wi, abs_cos_theta(wi) * INV_PI


def lambertian_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


def oren_nayar_f(r, sigma_deg, wo, wi):
    sigma = torch.deg2rad(sigma_deg)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + f32(0.33)))
    b = f32(0.45) * s2 / (s2 + f32(0.09))
    sin_ti, sin_to = sin_theta(wi), sin_theta(wo)
    max_cos = torch.clamp(cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo), min=0.0)
    abs_ci, abs_co = abs_cos_theta(wi), abs_cos_theta(wo)
    big = abs_ci > abs_co
    sin_alpha = torch.where(big, sin_to, sin_ti)
    tan_beta = torch.where(big, sin_ti / torch.clamp(abs_ci, min=f32(1e-6)),
                           sin_to / torch.clamp(abs_co, min=f32(1e-6)))
    val = r * (INV_PI * (a + b * max_cos * sin_alpha * tan_beta))[..., None]
    return torch.where(same_hemisphere(wo, wi)[..., None], val, 0.0)


def microfacet_reflection_f(rs, ax, ay, fresnel_fn, wo, wi):
    """Torrance–Sparrow with GGX; fresnel_fn(cos) -> (..., 3)."""
    co, ci = abs_cos_theta(wo), abs_cos_theta(wi)
    wh = wi + wo
    degenerate = (ci == 0.0) | (co == 0.0) | (vm.length_squared(wh) == 0.0)
    wh_n = vm.normalize(wh)
    # face_forward(wh_n, +z): flip wh_n to the upper hemisphere
    f = fresnel_fn(vm.dot(wi, torch.where(wh_n[..., 2:3] < 0.0, -wh_n, wh_n)))
    d = ggx_d(ax, ay, wh_n)
    g = ggx_g(ax, ay, wo, wi)
    val = rs * f * (d * g / torch.clamp(4.0 * co * ci, min=f32(1e-8)))[..., None]
    ok = same_hemisphere(wo, wi) & ~degenerate
    return torch.where(ok[..., None], val, 0.0)


def microfacet_reflection_pdf(ax, ay, wo, wi):
    wh = vm.normalize(wo + wi)
    pdf = ggx_pdf(ax, ay, wo, wh) / torch.clamp(4.0 * vm.absdot(wo, wh), min=f32(1e-8))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)
