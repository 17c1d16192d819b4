"""The Disney principled BSDF (counterpart of pbrt_tpu/shade/disney.py):
diffuse with retro-reflection, sheen, a GGX metallic / specular lobe and a
GTR1 clearcoat, over baseColor, metallic, roughness, specTint, sheen,
sheenTint, clearcoat and clearcoatGloss. Local frame, batched."""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.spectrum import luminance
from ..core.types import INV_PI, PI, f32, safe_sqrt
from . import bxdf


def _lerp(t, a, b):
    return (1.0 - t) * a + t * b


def _schlick_weight(c):
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _gtr1(cos_theta_h, alpha):
    a2 = alpha * alpha
    denom = PI * torch.log(torch.clamp(a2, min=f32(1e-6))) * (1.0 + (a2 - 1.0) * cos_theta_h ** 2)
    return (a2 - 1.0) / torch.where(denom.abs() > f32(1e-9), denom, f32(1e-9))


def _smith_g_ggx(cos_v, alpha):
    a2 = alpha * alpha
    b = cos_v * cos_v
    return 1.0 / torch.clamp(cos_v + safe_sqrt(a2 + b - a2 * b), min=f32(1e-8))


def disney_f(base_color, metallic, roughness, spec_tint, sheen, sheen_tint,
             clearcoat, cc_gloss, wo, wi):
    """f(wo, wi) in the local frame, (..., 3)."""
    same = bxdf.same_hemisphere(wo, wi)
    co = bxdf.abs_cos_theta(wo)
    ci = bxdf.abs_cos_theta(wi)
    wh = vm.normalize(wo + wi)
    cos_d = vm.dot(wi, wh)
    lum = torch.clamp(luminance(base_color), min=f32(1e-6))
    tint = base_color / lum[..., None]

    fo = _schlick_weight(co)
    fi = _schlick_weight(ci)
    f_d = base_color * INV_PI * ((1.0 - 0.5 * fo) * (1.0 - 0.5 * fi))[..., None]
    rr = 2.0 * roughness * cos_d * cos_d
    f_retro = base_color * INV_PI * (rr * (fo + fi + fo * fi * (rr - 1.0)))[..., None]

    c_sheen = _lerp(sheen_tint[..., None], torch.ones_like(tint), tint)
    f_sheen = sheen[..., None] * c_sheen * _schlick_weight(cos_d)[..., None]

    alpha = torch.clamp(roughness * roughness, min=f32(1e-3))
    d_s = bxdf.mf_d(bxdf.DIST_GGX, alpha, alpha, wh)
    c_spec0 = _lerp(metallic[..., None],
                    f32(0.08) * _lerp(spec_tint[..., None], torch.ones_like(tint), tint),
                    base_color)
    f_spec_fresnel = c_spec0 + (1.0 - c_spec0) * _schlick_weight(cos_d)[..., None]
    g_s = _smith_g_ggx(co, alpha) * _smith_g_ggx(ci, alpha)
    f_spec = f_spec_fresnel * (d_s * g_s / 4.0)[..., None]

    a_cc = _lerp(cc_gloss, f32(0.1), f32(0.001))
    d_cc = _gtr1(bxdf.abs_cos_theta(wh), a_cc)
    f_cc_fr = f32(0.04) + f32(0.96) * _schlick_weight(cos_d)
    g_cc = _smith_g_ggx(co, torch.full_like(co, 0.25)) * _smith_g_ggx(ci, torch.full_like(ci, 0.25))
    f_cc = (0.25 * clearcoat * d_cc * f_cc_fr * g_cc)[..., None]

    f_total = (1.0 - metallic)[..., None] * (f_d + f_retro + f_sheen) + f_spec + f_cc
    return torch.where(same[..., None], f_total, 0.0)


def disney_pdf(roughness, metallic, clearcoat, wo, wi):
    alpha = torch.clamp(roughness * roughness, min=f32(1e-3))
    pdf_diff = bxdf.abs_cos_theta(wi) * INV_PI
    pdf_spec = bxdf.microfacet_reflection_pdf(bxdf.DIST_GGX, alpha, alpha, wo, wi)
    w_spec = 0.5 + 0.5 * metallic
    pdf = (1.0 - w_spec) * pdf_diff + w_spec * pdf_spec
    return torch.where(bxdf.same_hemisphere(wo, wi), pdf, 0.0)


def disney_sample(base_color, metallic, roughness, spec_tint, sheen, sheen_tint,
                  clearcoat, cc_gloss, wo, u_lobe, u2):
    alpha = torch.clamp(roughness * roughness, min=f32(1e-3))
    use_spec = u_lobe < 0.5 + 0.5 * metallic
    wi_d, _ = bxdf.lambertian_sample(wo, u2)
    wi_s = vm.reflect(wo, bxdf.mf_sample_wh(bxdf.DIST_GGX, alpha, alpha, wo, u2))
    wi = torch.where(use_spec[..., None], wi_s, wi_d)
    f = disney_f(base_color, metallic, roughness, spec_tint, sheen, sheen_tint,
                 clearcoat, cc_gloss, wo, wi)
    pdf = disney_pdf(roughness, metallic, clearcoat, wo, wi)
    ok = bxdf.same_hemisphere(wo, wi)
    return wi, torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)
