"""BxDF lobes in the shading-local frame (counterpart of
pbrt_tpu/shade/bxdf.py): Lambert reflection and transmission, Oren–Nayar,
microfacet reflection and transmission over the Beckmann or the GGX
(Trowbridge–Reitz, visible-normal sampling) distribution, FresnelBlend,
dielectric, conductor and Schlick Fresnel, and the specular (delta)
reflection and transmission lobes."""
from __future__ import annotations

import numpy as np
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


def reflect_local(wo):
    return torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], -1)


def _up(w):
    """Flip w to the upper hemisphere (face_forward(w, +z))."""
    return torch.where(w[..., 2:3] < 0.0, -w, w)


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


def fresnel_conductor(cos_theta_i, eta_i, eta_t, k):
    """Fresnel reflectance of a conductor per channel: eta_i (...,),
    eta_t and k (..., 3)."""
    ci = torch.clamp(cos_theta_i.abs(), 0.0, 1.0)[..., None]
    ei = eta_i[..., None] if eta_i.dim() < eta_t.dim() else eta_i
    eta = eta_t / ei
    etak = k / (eta_i[..., None] if eta_i.dim() < k.dim() else eta_i)
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    etak2 = etak * etak
    t0 = eta2 - etak2 - si2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * eta2 * etak2)
    t1 = a2b2 + ci2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=f32(1e-12))
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=f32(1e-12))
    return 0.5 * (rp + rs)


def fresnel_schlick(cos_theta_i, r0):
    """Schlick's approximation: r0 (..., 3), cos_theta_i (...,)."""
    m = torch.clamp(1.0 - cos_theta_i.abs(), 0.0, 1.0)
    return r0 + (1.0 - r0) * (m ** 5)[..., None]


def roughness_to_alpha(roughness):
    """PBRT-v3 TrowbridgeReitz roughness remap."""
    x = torch.log(torch.clamp(roughness, min=f32(1e-3)))
    return (f32(1.62142) + f32(0.819955) * x + f32(0.1734) * x * x
            + f32(0.0171201) * x ** 3 + f32(0.000640711) * x ** 4)


DIST_GGX = 0
DIST_BECKMANN = 1


def _alpha_clamp(a):
    return torch.clamp(a, min=f32(1e-3))


def mf_d(dist, ax, ay, wh):
    """Normal distribution D(wh) of Beckmann or GGX (Trowbridge–Reitz)."""
    ax, ay = _alpha_clamp(ax), _alpha_clamp(ay)
    t2 = tan2_theta(wh)
    c4 = cos2_theta(wh) ** 2
    cp2, sp2 = cos_phi(wh) ** 2, sin_phi(wh) ** 2
    if dist == DIST_BECKMANN:
        d = torch.exp(-t2 * (cp2 / (ax * ax) + sp2 / (ay * ay))) \
            / (PI * ax * ay * torch.clamp(c4, min=f32(1e-12)))
    else:
        e = (cp2 / (ax * ax) + sp2 / (ay * ay)) * t2
        d = 1.0 / (PI * ax * ay * torch.clamp(c4, min=f32(1e-12))
                   * torch.clamp((1.0 + e) ** 2, min=f32(1e-12)))
    return torch.where(torch.isfinite(t2), d, 0.0)


def mf_lambda(dist, ax, ay, w):
    ax, ay = _alpha_clamp(ax), _alpha_clamp(ay)
    abs_tan = tan_theta(w).abs()
    alpha = torch.sqrt(cos_phi(w) ** 2 * ax * ax + sin_phi(w) ** 2 * ay * ay)
    if dist == DIST_BECKMANN:
        a = 1.0 / torch.clamp(alpha * abs_tan, min=f32(1e-12))
        lam = torch.where(a >= f32(1.6), 0.0,
                          (1.0 - f32(1.259) * a + f32(0.396) * a * a)
                          / (f32(3.535) * a + f32(2.181) * a * a))
    else:
        lam = (-1.0 + torch.sqrt(1.0 + (alpha * abs_tan) ** 2)) / 2.0
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def mf_g1(dist, ax, ay, w):
    return 1.0 / (1.0 + mf_lambda(dist, ax, ay, w))


def mf_g(dist, ax, ay, wo, wi):
    return 1.0 / (1.0 + mf_lambda(dist, ax, ay, wo) + mf_lambda(dist, ax, ay, wi))


def mf_sample_wh(dist, ax, ay, wo, u2):
    """A half vector: GGX by visible-normal sampling (Heitz 2018),
    Beckmann by inverting the full distribution."""
    ax, ay = _alpha_clamp(ax), _alpha_clamp(ay)
    if dist == DIST_BECKMANN:
        log_u = torch.log(torch.clamp(1.0 - u2[..., 0], min=f32(1e-10)))
        phi = torch.atan2(ay * torch.sin(2.0 * PI * u2[..., 1] + f32(0.5 * PI)),
                          ax * torch.cos(2.0 * PI * u2[..., 1] + f32(0.5 * PI)))
        cp, sp = torch.cos(phi), torch.sin(phi)
        t2 = -log_u / torch.clamp(cp * cp / (ax * ax) + sp * sp / (ay * ay), min=f32(1e-12))
        ct = 1.0 / torch.sqrt(1.0 + t2)
        st = safe_sqrt(1.0 - ct * ct)
        wh = vm.spherical_direction(st, ct, phi)
        return torch.where(same_hemisphere(wo, wh)[..., None], wh, -wh)
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


def mf_pdf(dist, ax, ay, wo, wh):
    """pdf of mf_sample_wh w.r.t. the solid angle of wh."""
    if dist == DIST_BECKMANN:
        return mf_d(dist, ax, ay, wh) * abs_cos_theta(wh)
    return mf_d(dist, ax, ay, wh) * mf_g1(dist, ax, ay, wo) * vm.absdot(wo, wh) \
        / torch.clamp(abs_cos_theta(wo), min=f32(1e-8))


def lambertian_f(r, wo, wi):
    return torch.where(same_hemisphere(wo, wi)[..., None], r * INV_PI, 0.0)


def _flip_z(w, flip):
    return torch.where(flip[..., None], torch.cat([w[..., :2], -w[..., 2:]], -1), w)


def lambertian_sample(wo, u2):
    """Cosine-weighted direction on wo's side. Returns (wi, pdf)."""
    wi = _flip_z(cosine_sample_hemisphere(u2), wo[..., 2] < 0.0)
    return wi, abs_cos_theta(wi) * INV_PI


def lambertian_pdf(wo, wi):
    return torch.where(same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


def lambertian_transmission_f(t, wo, wi):
    return torch.where(~same_hemisphere(wo, wi)[..., None], t * INV_PI, 0.0)


def lambertian_transmission_sample(wo, u2):
    """Cosine-weighted direction on the side opposite wo. Returns (wi, pdf)."""
    wi = _flip_z(cosine_sample_hemisphere(u2), wo[..., 2] > 0.0)
    return wi, abs_cos_theta(wi) * INV_PI


def lambertian_transmission_pdf(wo, wi):
    return torch.where(~same_hemisphere(wo, wi), abs_cos_theta(wi) * INV_PI, 0.0)


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


def microfacet_reflection_f(rs, dist, ax, ay, fresnel_fn, wo, wi):
    """Torrance–Sparrow; fresnel_fn(cos) -> (..., 3)."""
    co, ci = abs_cos_theta(wo), abs_cos_theta(wi)
    wh = wi + wo
    degenerate = (ci == 0.0) | (co == 0.0) | (vm.length_squared(wh) == 0.0)
    wh_n = vm.normalize(wh)
    f = fresnel_fn(vm.dot(wi, _up(wh_n)))
    d = mf_d(dist, ax, ay, wh_n)
    g = mf_g(dist, ax, ay, wo, wi)
    val = rs * f * (d * g / torch.clamp(4.0 * co * ci, min=f32(1e-8)))[..., None]
    ok = same_hemisphere(wo, wi) & ~degenerate
    return torch.where(ok[..., None], val, 0.0)


def microfacet_reflection_pdf(dist, ax, ay, wo, wi):
    wh = vm.normalize(wo + wi)
    pdf = mf_pdf(dist, ax, ay, wo, wh) / torch.clamp(4.0 * vm.absdot(wo, wh), min=f32(1e-8))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def microfacet_reflection_sample(rs, dist, ax, ay, fresnel_fn, wo, u2):
    wh = mf_sample_wh(dist, ax, ay, wo, u2)
    wi = vm.reflect(wo, wh)
    pdf = mf_pdf(dist, ax, ay, wo, wh) / torch.clamp(4.0 * vm.absdot(wo, wh), min=f32(1e-8))
    ok = same_hemisphere(wo, wi) & (vm.dot(wo, wh) > 0.0)
    f = microfacet_reflection_f(rs, dist, ax, ay, fresnel_fn, wo, wi)
    return wi, torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def microfacet_transmission_f(ts, dist, ax, ay, eta_a, eta_b, wo, wi, mode_radiance=True):
    """Rough dielectric transmission; radiance transport divides by eta²."""
    co, ci = cos_theta(wo), cos_theta(wi)
    eta = torch.where(co > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = _up(vm.normalize(wo + wi * eta[..., None]))
    denom_ok = (vm.dot(wo, wh) * vm.dot(wi, wh)) <= 0.0
    fr = fresnel_dielectric(vm.dot(wo, wh), eta_a, eta_b)
    d = mf_d(dist, ax, ay, wh)
    g = mf_g(dist, ax, ay, wo, wi)
    sqrt_denom = vm.dot(wo, wh) + eta * vm.dot(wi, wh)
    factor = 1.0 / torch.clamp(eta, min=f32(1e-8)) if mode_radiance else torch.ones_like(eta)
    scalar = (d * g * eta * eta * vm.absdot(wi, wh) * vm.absdot(wo, wh) * factor * factor
              / torch.clamp((ci * co).abs() * sqrt_denom * sqrt_denom, min=f32(1e-10))).abs()
    val = (1.0 - fr)[..., None] * ts * scalar[..., None]
    ok = (~same_hemisphere(wo, wi)) & (ci != 0.0) & (co != 0.0) & denom_ok
    return torch.where(ok[..., None], val, 0.0)


def microfacet_transmission_pdf(dist, ax, ay, eta_a, eta_b, wo, wi):
    eta = torch.where(cos_theta(wo) > 0.0, eta_b / eta_a, eta_a / eta_b)
    wh = vm.normalize(wo + wi * eta[..., None])
    sqrt_denom = vm.dot(wo, wh) + eta * vm.dot(wi, wh)
    dwh_dwi = ((eta * eta * vm.dot(wi, wh))
               / torch.clamp(sqrt_denom * sqrt_denom, min=f32(1e-10))).abs()
    pdf = mf_pdf(dist, ax, ay, wo, _up(wh)) * dwh_dwi
    return torch.where(~same_hemisphere(wo, wi), pdf, 0.0)


def microfacet_transmission_sample(ts, dist, ax, ay, eta_a, eta_b, wo, u2):
    wh = mf_sample_wh(dist, ax, ay, wo, u2)
    eta = torch.where(cos_theta(wo) > 0.0, eta_a / eta_b, eta_b / eta_a)
    refr_ok, wi = vm.refract(wo, vm.face_forward(wh, wo), eta)
    f = microfacet_transmission_f(ts, dist, ax, ay, eta_a, eta_b, wo, wi)
    pdf = microfacet_transmission_pdf(dist, ax, ay, eta_a, eta_b, wo, wi)
    ok = (vm.dot(wo, wh) > 0.0) & refr_ok
    return wi, torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


# 28 / (23 π) rounded as float32 arithmetic rounds it
_FB_DIFFUSE = float(np.float32(28.0) / (np.float32(23.0) * np.float32(np.pi)))


def fresnel_blend_f(rd, rs, dist, ax, ay, wo, wi):
    """Ashikhmin–Shirley substrate: a diffuse base under a glossy coat."""
    def pow5(v):
        return (v * v) * (v * v) * v
    diffuse = (_FB_DIFFUSE * rd * (1.0 - rs)
               * ((1.0 - pow5(1.0 - 0.5 * abs_cos_theta(wi)))
                  * (1.0 - pow5(1.0 - 0.5 * abs_cos_theta(wo))))[..., None])
    wh = wi + wo
    wh_ok = vm.length_squared(wh) > f32(1e-12)
    wh_n = vm.normalize(wh)
    d = mf_d(dist, ax, ay, wh_n)
    spec = (d / torch.clamp(4.0 * vm.absdot(wi, wh_n)
                            * torch.maximum(abs_cos_theta(wi), abs_cos_theta(wo)),
                            min=f32(1e-8)))[..., None] * fresnel_schlick(vm.dot(wi, wh_n), rs)
    val = diffuse + torch.where(wh_ok[..., None], spec, 0.0)
    return torch.where(same_hemisphere(wo, wi)[..., None], val, 0.0)


def fresnel_blend_pdf(dist, ax, ay, wo, wi):
    wh = vm.normalize(wo + wi)
    pdf_wh = mf_pdf(dist, ax, ay, wo, wh)
    pdf = 0.5 * (abs_cos_theta(wi) * INV_PI
                 + pdf_wh / torch.clamp(4.0 * vm.absdot(wo, wh), min=f32(1e-8)))
    return torch.where(same_hemisphere(wo, wi), pdf, 0.0)


def fresnel_blend_sample(rd, rs, dist, ax, ay, wo, u2, u_lobe):
    """Half the samples cosine-weighted, half from the microfacet lobe."""
    wi_d, _ = lambertian_sample(wo, u2)
    wi_s = vm.reflect(wo, mf_sample_wh(dist, ax, ay, wo, u2))
    wi = torch.where((u_lobe < 0.5)[..., None], wi_s, wi_d)
    f = fresnel_blend_f(rd, rs, dist, ax, ay, wo, wi)
    pdf = fresnel_blend_pdf(dist, ax, ay, wo, wi)
    ok = same_hemisphere(wo, wi)
    return wi, torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


# specular (delta) lobes: sampled only; their f and pdf are 0

def specular_reflection_sample(r, fresnel_fn, wo):
    wi = reflect_local(wo)
    f = fresnel_fn(cos_theta(wi)) * r / torch.clamp(abs_cos_theta(wi), min=f32(1e-8))[..., None]
    return wi, f, torch.ones_like(wo[..., 0])


def specular_transmission_sample(t, eta_a, eta_b, wo, mode_radiance=True):
    """Returns (wi, f, pdf, ok); radiance transport scales f by
    (eta_i / eta_t)²."""
    entering = cos_theta(wo) > 0.0
    ei = torch.where(entering, eta_a, eta_b)
    et = torch.where(entering, eta_b, eta_a)
    n = torch.zeros_like(wo)
    n[..., 2] = 1.0
    ok, wi = vm.refract(wo, vm.face_forward(n, wo), ei / et)
    fr = fresnel_dielectric(cos_theta(wo), eta_a, eta_b)
    scale = (ei * ei) / torch.clamp(et * et, min=f32(1e-12)) if mode_radiance \
        else torch.ones_like(ei)
    f = (1.0 - fr)[..., None] * t * (scale / torch.clamp(abs_cos_theta(wi), min=f32(1e-8)))[..., None]
    return wi, torch.where(ok[..., None], f, 0.0), torch.where(ok, 1.0, 0.0), ok


def fresnel_specular_sample(r, t, eta_a, eta_b, wo, u, mode_radiance=True):
    """Smooth dielectric, reflection or transmission chosen by Fresnel.
    Returns (wi, f, pdf, is_transmission)."""
    fr = fresnel_dielectric(cos_theta(wo), eta_a, eta_b)
    choose_r = u < fr
    wi_r = reflect_local(wo)
    f_r = (fr / torch.clamp(abs_cos_theta(wi_r), min=f32(1e-8)))[..., None] * r
    wi_t, f_t, pdf_t, ok_t = specular_transmission_sample(t, eta_a, eta_b, wo, mode_radiance)
    return (torch.where(choose_r[..., None], wi_r, wi_t),
            torch.where(choose_r[..., None], f_r, f_t),
            torch.where(choose_r, fr, (1.0 - fr) * pdf_t), ~choose_r & ok_t)
