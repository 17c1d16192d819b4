"""Material table and wavefront BSDF dispatch for MAT_MATTE, MAT_PLASTIC,
MAT_GLASS and MAT_MIRROR (counterpart of pbrt_tpu/shade/materials.py).
The table keeps one `kind` per material; each kind present in the scene
is evaluated under a lane mask."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.types import f32
from . import bxdf

MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_GLASS = 2
MAT_MIRROR = 4
# kinds not ported (materials_from_numpy refuses them), numbered as in the
# reference: SPPM's visible-point test names them
MAT_SUBSTRATE = 5
MAT_TRANSLUCENT = 6
MAT_UBER = 7
PORTED_KINDS = (MAT_MATTE, MAT_PLASTIC, MAT_GLASS, MAT_MIRROR)
UNPORTED_CHANNELS = ("ks_tex", "kr_tex", "kt_tex", "roughness_tex", "sigma_tex", "bump_tex")


@dataclass
class MaterialTable:
    kind: torch.Tensor            # (M,) int64
    kd: torch.Tensor              # (M, 3)
    ks: torch.Tensor              # (M, 3)
    kr: torch.Tensor              # (M, 3) specular reflectance (glass, mirror)
    kt: torch.Tensor              # (M, 3) transmittance (glass)
    roughness: torch.Tensor       # (M, 2)
    eta: torch.Tensor             # (M,)
    sigma: torch.Tensor           # (M,) Oren–Nayar sigma, degrees
    remap_roughness: torch.Tensor  # (M,) bool
    kd_tex: torch.Tensor          # (M,) int64 texture id or -1
    kinds_present: tuple = ()
    tex_channels: tuple = ()      # channels with any texture: ("kd",) or ()
    # per-material medium interface: the medium id a ray enters when it
    # transmits into (against ng) / out of the surface, -1 = vacuum; None
    # when no row sets one (volpath keeps the lane's medium)
    med_inside: Optional[torch.Tensor] = None    # (M,) int64
    med_outside: Optional[torch.Tensor] = None   # (M,) int64


def materials_from_numpy(arrs, device):
    """MaterialTable from numpy columns: kind, kd, ks, kr, kt, roughness, eta,
    sigma, remap_roughness, kd_tex, the texture ids of the channels not
    ported (UNPORTED_CHANNELS, all -1) and the medium interface columns
    med_inside and med_outside (None, or (M,) ids), as the JAX package's
    build_materials lays them out. A table that leaves out one of those
    channels or columns is refused: a texture or an interface would be
    dropped without a word."""
    kind = np.asarray(arrs["kind"], np.int64)
    bad = sorted(set(kind.tolist()) - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(f"material kinds {bad} are not ported yet")
    kd_tex = np.asarray(arrs["kd_tex"], np.int64)
    for ch in UNPORTED_CHANNELS:
        if ch not in arrs:
            raise NotImplementedError(f"the material table does not state {ch}: texture "
                                      "channels other than kd are not ported")
        if (np.asarray(arrs[ch]) >= 0).any():
            raise NotImplementedError(f"texture channel {ch} is not ported yet")
    missing = [k for k in ("med_inside", "med_outside") if k not in arrs]
    if missing:
        raise NotImplementedError(f"the material table does not state {missing}: a "
                                  "table must show its medium interfaces (None or ids)")
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    iface = {k: None if arrs[k] is None else t(arrs[k], torch.int64)
             for k in ("med_inside", "med_outside")}
    return MaterialTable(kind=t(kind, torch.int64), kd=t(arrs["kd"]), ks=t(arrs["ks"]),
                         kr=t(arrs["kr"]), kt=t(arrs["kt"]), roughness=t(arrs["roughness"]), eta=t(arrs["eta"]),
                         sigma=t(arrs["sigma"]),
                         remap_roughness=t(arrs["remap_roughness"], torch.bool),
                         kd_tex=t(kd_tex, torch.int64),
                         kinds_present=tuple(sorted(set(kind.tolist()))),
                         tex_channels=("kd",) if (kd_tex >= 0).any() else (), **iface)


def build_materials(rows, device):
    """Rows as the JAX package's SceneBuilder records them (dicts with
    kind, kd, ks, kr, kt, roughness, eta, sigma, remap_roughness, kd_tex,
    and med_inside / med_outside on rows with a medium interface)."""
    m = len(rows)
    has_iface = any("med_inside" in r or "med_outside" in r for r in rows)

    def col(key, default, shape=()):
        out = np.zeros((m,) + shape, np.float32)
        for i, r in enumerate(rows):
            v = r.get(key, default)
            out[i] = np.broadcast_to(np.asarray(v, np.float32), shape) if shape else v
        return out

    return materials_from_numpy(dict(
        kind=[int(r["kind"]) for r in rows], kd=col("kd", 0.5, (3,)),
        ks=col("ks", 0.0, (3,)), kr=col("kr", 0.0, (3,)), kt=col("kt", 0.0, (3,)),
        roughness=col("roughness", 0.0, (2,)),
        eta=col("eta", 1.5), sigma=col("sigma", 0.0),
        remap_roughness=[bool(r.get("remap_roughness", True)) for r in rows],
        kd_tex=[r.get("kd_tex", -1) for r in rows],
        **{k: [r.get(k, -1) for r in rows] if has_iface else None
           for k in ("med_inside", "med_outside")},
        **{ch: [r.get(ch, -1) for r in rows] for ch in UNPORTED_CHANNELS}), device)


@dataclass
class LaneParams:
    """Per-lane resolved material parameters."""
    kind: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    kr: Optional[torch.Tensor]     # None when no glass or mirror is present
    kt: Optional[torch.Tensor]
    ax: torch.Tensor
    ay: torch.Tensor
    eta: torch.Tensor
    sigma: torch.Tensor
    rough_is_zero: Optional[torch.Tensor]   # smooth: glass takes its delta lobes


def resolve(mats: MaterialTable, mid, uv=None, p=None, textures=None, fp=None):
    """Gather per-lane parameters for material ids `mid`, applying the
    kd texture where one is set; `fp` is the ray-cone footprint in uv."""
    mid = torch.clamp(mid, min=0)
    kd = mats.kd[mid]
    if textures is not None and uv is not None and "kd" in mats.tex_channels:
        from . import textures as texmod
        kd = texmod.apply_tex(textures, mats.kd_tex[mid], uv, p, kd, fp=fp)
    rough = mats.roughness[mid]
    remap = mats.remap_roughness[mid]
    ax = torch.where(remap, bxdf.roughness_to_alpha(rough[..., 0]), rough[..., 0])
    ay = torch.where(remap, bxdf.roughness_to_alpha(rough[..., 1]), rough[..., 1])
    specular = bool({MAT_GLASS, MAT_MIRROR} & set(mats.kinds_present))
    return LaneParams(kind=mats.kind[mid], kd=kd, ks=mats.ks[mid],
                      kr=mats.kr[mid] if specular else None,
                      kt=mats.kt[mid] if specular else None, ax=ax, ay=ay,
                      eta=mats.eta[mid], sigma=mats.sigma[mid],
                      rough_is_zero=(rough.amax(-1) < f32(1e-5)) if specular else None)


def _fresnel_rgb(eta):
    def fr(c):
        return bxdf.fresnel_dielectric(c, torch.ones_like(eta), eta)[..., None].expand(
            *c.shape, 3)
    return fr


def _matte_f(lp, wo, wi):
    return bxdf.oren_nayar_f(lp.kd, lp.sigma, wo, wi)


def _matte_pdf(lp, wo, wi):
    return bxdf.lambertian_pdf(wo, wi)


def _matte_sample(lp, wo, u_lobe, u2):
    """Each kind's sample returns (wi, f, pdf, is_specular,
    is_transmission), the last two None where always false."""
    wi, pdf = bxdf.lambertian_sample(wo, u2)
    return wi, _matte_f(lp, wo, wi), pdf, None, None


def _plastic_f(lp, wo, wi):
    return bxdf.lambertian_f(lp.kd, wo, wi) + bxdf.microfacet_reflection_f(
        lp.ks, lp.ax, lp.ay, _fresnel_rgb(lp.eta), wo, wi)


def _plastic_pdf(lp, wo, wi):
    return 0.5 * (bxdf.lambertian_pdf(wo, wi)
                  + bxdf.microfacet_reflection_pdf(lp.ax, lp.ay, wo, wi))


def _plastic_sample(lp, wo, u_lobe, u2):
    use_spec = u_lobe < 0.5
    wi_d, _ = bxdf.lambertian_sample(wo, u2)
    wh = bxdf.ggx_sample_wh(lp.ax, lp.ay, wo, u2)
    wi = torch.where(use_spec[..., None], vm.reflect(wo, wh), wi_d)
    ok = bxdf.same_hemisphere(wo, wi)
    return (wi, torch.where(ok[..., None], _plastic_f(lp, wo, wi), 0.0),
            torch.where(ok, _plastic_pdf(lp, wo, wi), 0.0), None, None)


def _glass_f(lp, wo, wi):
    one = torch.ones_like(lp.eta)
    rough = (bxdf.microfacet_reflection_f(lp.kr, lp.ax, lp.ay, _fresnel_rgb(lp.eta), wo, wi)
             + bxdf.microfacet_transmission_f(lp.kt, lp.ax, lp.ay, one, lp.eta, wo, wi))
    return torch.where(lp.rough_is_zero[..., None], 0.0, rough)


def _glass_pdf(lp, wo, wi):
    one = torch.ones_like(lp.eta)
    pdf = 0.5 * (bxdf.microfacet_reflection_pdf(lp.ax, lp.ay, wo, wi)
                 + bxdf.microfacet_transmission_pdf(lp.ax, lp.ay, one, lp.eta, wo, wi))
    return torch.where(lp.rough_is_zero, 0.0, pdf)


def _glass_sample(lp, wo, u_lobe, u2):
    """Smooth glass: the Fresnel-chosen delta lobes; rough glass: GGX
    reflection or transmission, each with probability 1/2."""
    one = torch.ones_like(lp.eta)
    wi_d, f_d, pdf_d, trans_d = bxdf.fresnel_specular_sample(lp.kr, lp.kt, one, lp.eta, wo,
                                                             u_lobe)
    use_t = u_lobe >= 0.5
    wi_r, _, _ = bxdf.microfacet_reflection_sample(lp.kr, lp.ax, lp.ay, _fresnel_rgb(lp.eta),
                                                   wo, u2)
    wi_t, _, _ = bxdf.microfacet_transmission_sample(lp.kt, lp.ax, lp.ay, one, lp.eta, wo, u2)
    wi_rough = torch.where(use_t[..., None], wi_t, wi_r)
    is0 = lp.rough_is_zero
    return (torch.where(is0[..., None], wi_d, wi_rough),
            torch.where(is0[..., None], f_d, _glass_f(lp, wo, wi_rough)),
            torch.where(is0, pdf_d, _glass_pdf(lp, wo, wi_rough)), is0,
            torch.where(is0, trans_d, use_t & ~bxdf.same_hemisphere(wo, wi_rough)))


def _mirror_sample(lp, wo, u_lobe, u2):
    wi, f, pdf = bxdf.specular_reflection_sample(lp.kr, lambda c: torch.ones_like(wo), wo)
    return wi, f, pdf, torch.ones_like(pdf, dtype=torch.bool), None


def _zero_f(lp, wo, wi):
    return torch.zeros_like(wo)


def _zero_pdf(lp, wo, wi):
    return torch.zeros_like(wo[..., 0])


_F = {MAT_MATTE: _matte_f, MAT_PLASTIC: _plastic_f, MAT_GLASS: _glass_f,
      MAT_MIRROR: _zero_f}
_PDF = {MAT_MATTE: _matte_pdf, MAT_PLASTIC: _plastic_pdf, MAT_GLASS: _glass_pdf,
        MAT_MIRROR: _zero_pdf}
_SAMPLE = {MAT_MATTE: _matte_sample, MAT_PLASTIC: _plastic_sample, MAT_GLASS: _glass_sample,
           MAT_MIRROR: _mirror_sample}


def evaluate_f(lp: LaneParams, kinds_present, wo, wi):
    """BSDF value in the local frame; masked over the kinds present."""
    out = torch.zeros_like(wo)
    for k in kinds_present:
        out = torch.where((lp.kind == k)[..., None], _F[k](lp, wo, wi), out)
    return out


def pdf(lp: LaneParams, kinds_present, wo, wi):
    out = torch.zeros_like(wo[..., 0])
    for k in kinds_present:
        out = torch.where(lp.kind == k, _PDF[k](lp, wo, wi), out)
    return out


def sample(lp: LaneParams, kinds_present, wo, u_lobe, u2):
    """Returns (wi, f, pdf, is_specular, is_transmission)."""
    wi = torch.zeros_like(wo)
    f = torch.zeros_like(wo)
    pdf_out = torch.zeros_like(wo[..., 0])
    flags = [None, None]        # is_specular, is_transmission
    for k in kinds_present:
        mask = lp.kind == k
        wi_k, f_k, pdf_k, *flags_k = _SAMPLE[k](lp, wo, u_lobe, u2)
        wi = torch.where(mask[..., None], wi_k, wi)
        f = torch.where(mask[..., None], f_k, f)
        pdf_out = torch.where(mask, pdf_k, pdf_out)
        for i, fk in enumerate(flags_k):     # the kinds' masks are disjoint
            if fk is not None:
                flags[i] = (mask & fk) if flags[i] is None else torch.where(mask, fk, flags[i])
    no = torch.zeros_like(pdf_out, dtype=torch.bool)
    return (wi, f, pdf_out, *(no if fl is None else fl for fl in flags))


def eta_scale_on_transmit(lp: LaneParams, wo_z):
    """The eta² factor a transmission event applies to the Russian
    roulette throughput."""
    eta = lp.eta
    return torch.where(wo_z > 0.0, eta * eta, 1.0 / torch.clamp(eta * eta, min=f32(1e-8)))
