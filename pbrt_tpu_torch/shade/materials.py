"""Material table and wavefront BSDF dispatch (counterpart of
pbrt_tpu/shade/materials.py): matte, plastic, glass, metal, mirror,
substrate, translucent, uber, Disney, mix, subsurface, hair and Fourier.

The table keeps one `kind` per material; each kind present in the scene
is evaluated under a lane mask. Every spatially varying parameter has a
texture id column (-1: the constant column), which `resolve` applies.
A mix row blends two other rows' BSDF values in `evaluate_f` when the
caller passes the table; the JAX package has no pdf or sample for it, so
neither has the port, and a scene with a mix row cannot render."""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.sampling import uniform_sample_sphere
from ..core.spectrum import luminance
from ..core.types import INV_PI, PI, f32
from ..diff.rows import rows
from . import bssrdf as bssr
from . import bxdf
from . import fourier as fouriermod

MAT_MATTE = 0
MAT_PLASTIC = 1
MAT_GLASS = 2
MAT_METAL = 3
MAT_MIRROR = 4
MAT_SUBSTRATE = 5
MAT_TRANSLUCENT = 6
MAT_UBER = 7
MAT_DISNEY = 8
MAT_MIX = 9
MAT_SUBSURFACE = 10
MAT_HAIR = 11
MAT_FOURIER = 12

_SPECULAR_KINDS = (MAT_GLASS, MAT_MIRROR, MAT_UBER)   # may sample delta lobes

TEX_CHANNELS = ("kd", "ks", "kr", "kt", "roughness", "sigma")   # resolve's channels
TEXTURE_COLUMNS = tuple(c + "_tex" for c in TEX_CHANNELS) + ("bump_tex",)
# column: (default of build_materials, per-row shape); remap_roughness and
# the texture ids are the other columns
FLOAT_COLUMNS = {"kd": (0.5, (3,)), "ks": (0.0, (3,)), "kr": (0.0, (3,)), "kt": (0.0, (3,)),
                 "roughness": (0.0, (2,)), "eta": (1.5, ()), "metal_eta": (0.2, (3,)),
                 "metal_k": (3.9, (3,)), "sigma": (0.0, ()), "opacity": (1.0, (3,)),
                 "aux": (0.0, (8,))}


@dataclass
class MaterialTable:
    kind: torch.Tensor            # (M,) int64
    kd: torch.Tensor              # (M, 3) diffuse / base reflectance
    ks: torch.Tensor              # (M, 3) glossy reflectance
    kr: torch.Tensor              # (M, 3) specular reflectance
    kt: torch.Tensor              # (M, 3) transmittance
    roughness: torch.Tensor       # (M, 2) u, v roughness
    eta: torch.Tensor             # (M,) dielectric index
    metal_eta: torch.Tensor       # (M, 3) conductor eta
    metal_k: torch.Tensor         # (M, 3) conductor absorption
    sigma: torch.Tensor           # (M,) Oren–Nayar sigma, degrees
    opacity: torch.Tensor         # (M, 3) uber opacity
    remap_roughness: torch.Tensor  # (M,) bool
    # kind-specific extras: Disney [metallic, specTint, sheen, sheenTint,
    # clearcoat, clearcoatGloss, roughness]; mix [row 1, row 2];
    # subsurface [sigma_a (3), sigma_s (3), g, scale]
    aux: torch.Tensor             # (M, 8)
    kd_tex: torch.Tensor          # (M,) int64 texture id or -1
    ks_tex: torch.Tensor
    kr_tex: torch.Tensor
    kt_tex: torch.Tensor
    roughness_tex: torch.Tensor
    sigma_tex: torch.Tensor
    bump_tex: torch.Tensor
    kinds_present: tuple = ()
    tex_channels: tuple = ()      # TEX_CHANNELS with any texture id >= 0
    tex_ids: dict = None          # texture column → the ids >= 0 it holds (host)
    has_bump: bool = False
    sss_table: Optional[bssr.BSSRDFTable] = None         # with subsurface rows
    fourier_table: Optional[fouriermod.FourierTable] = None   # with Fourier rows
    # per-material medium interface: the medium id a ray enters when it
    # transmits into (against ng) / out of the surface, -1 = vacuum; None
    # when no row sets one (volpath keeps the lane's medium)
    med_inside: Optional[torch.Tensor] = None    # (M,) int64
    med_outside: Optional[torch.Tensor] = None   # (M,) int64


def materials_from_numpy(arrs, device):
    """MaterialTable from numpy columns as the JAX package's
    build_materials lays them out: kind, remap_roughness, the
    FLOAT_COLUMNS, the TEXTURE_COLUMNS, med_inside and med_outside (None,
    or (M,) ids), and the tables sss_table (None, or the BSSRDFTable's
    fields) and fourier_table (None, a FourierTable, or its fields). A
    table that leaves one of them out is refused: a parameter, a texture,
    an interface or a profile would be dropped without a word; so is a
    subsurface or Fourier row without its table."""
    missing = [k for k in ("kind", "remap_roughness", *FLOAT_COLUMNS, *TEXTURE_COLUMNS,
                           "med_inside", "med_outside", "sss_table", "fourier_table")
               if k not in arrs]
    if missing:
        raise NotImplementedError(f"the material table does not state {missing}: a table "
                                  "must show every column, its medium interfaces and its "
                                  "subsurface and Fourier tables (None or arrays)")
    kind = np.asarray(arrs["kind"], np.int64)
    kinds = tuple(sorted(set(kind.tolist())))
    for k, table in ((MAT_SUBSURFACE, "sss_table"), (MAT_FOURIER, "fourier_table")):
        if k in kinds and arrs[table] is None:
            raise NotImplementedError(f"material kind {k} needs its {table}")
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    tex = {k: t(arrs[k], torch.int64) for k in TEXTURE_COLUMNS}
    ft = arrs["fourier_table"]
    if isinstance(ft, fouriermod.FourierTable):
        ft = fouriermod.FourierTable(ft.mu.to(device), ft.a.to(device), ft.m.to(device),
                                     ft.eta, ft.m_max)
    elif ft is not None:
        ft = fouriermod.table_from_numpy(ft, device)
    return MaterialTable(
        kind=t(kind, torch.int64), remap_roughness=t(arrs["remap_roughness"], torch.bool),
        **{k: t(arrs[k]) for k in FLOAT_COLUMNS}, **tex,
        kinds_present=kinds,
        tex_channels=tuple(c for c in TEX_CHANNELS if bool((tex[c + "_tex"] >= 0).any())),
        tex_ids={k: tuple(sorted({int(i) for i in np.asarray(arrs[k]).tolist() if i >= 0}))
                 for k in TEXTURE_COLUMNS},
        has_bump=bool((tex["bump_tex"] >= 0).any()),
        sss_table=(None if arrs["sss_table"] is None
                   else bssr.table_from_numpy(arrs["sss_table"], device)),
        fourier_table=ft,
        **{k: None if arrs[k] is None else t(arrs[k], torch.int64)
           for k in ("med_inside", "med_outside")})


def build_materials(rows, device):
    """Rows as the JAX package's SceneBuilder records them (dicts with
    kind and any of the FLOAT_COLUMNS, remap_roughness, the texture ids,
    med_inside / med_outside and a Fourier row's fourier_table). The
    BSSRDF table is built from the first subsurface row's g (aux[6]) and
    eta; the Fourier table is the last Fourier row's."""
    m = len(rows)
    kinds = {int(r["kind"]) for r in rows}

    def col(key, default, shape=()):
        out = np.zeros((m,) + shape, np.float32)
        for i, r in enumerate(rows):
            v = r.get(key, default)
            out[i] = np.broadcast_to(np.asarray(v, np.float32), shape) if shape else v
        return out

    has_iface = any("med_inside" in r or "med_outside" in r for r in rows)
    sss = None
    if MAT_SUBSURFACE in kinds:
        first = next(r for r in rows if int(r["kind"]) == MAT_SUBSURFACE)
        sss = bssr.beam_diffusion_table_np(g=float(first.get("aux", [0.0] * 8)[6]),
                                           eta=float(first.get("eta", 1.33)))
    fourier = None
    for r in rows:
        if int(r["kind"]) == MAT_FOURIER:
            fourier = r.get("fourier_table")
    return materials_from_numpy(dict(
        kind=[int(r["kind"]) for r in rows],
        remap_roughness=[bool(r.get("remap_roughness", True)) for r in rows],
        **{k: col(k, d, shp) for k, (d, shp) in FLOAT_COLUMNS.items()},
        **{k: [r.get(k, -1) for r in rows] for k in TEXTURE_COLUMNS},
        **{k: [r.get(k, -1) for r in rows] if has_iface else None
           for k in ("med_inside", "med_outside")},
        sss_table=sss, fourier_table=fourier), device)


@dataclass
class LaneParams:
    """Per-lane resolved material parameters."""
    kind: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    kr: torch.Tensor
    kt: torch.Tensor
    ax: torch.Tensor
    ay: torch.Tensor
    eta: torch.Tensor
    metal_eta: torch.Tensor
    metal_k: torch.Tensor
    sigma: torch.Tensor
    opacity: torch.Tensor
    rough_is_zero: torch.Tensor   # smooth: glass takes its delta lobes
    aux: torch.Tensor
    fourier: Optional[fouriermod.FourierTable] = None


def resolve(mats: MaterialTable, mid, uv=None, p=None, textures=None, fp=None):
    """Per-lane parameters of material ids `mid`, each textured channel
    evaluated where its id is set; `fp` is the ray-cone footprint in uv."""
    mid = torch.clamp(mid, min=0)
    kd, ks, kr, kt = (rows(mats.kd, mid), rows(mats.ks, mid), rows(mats.kr, mid),
                      rows(mats.kt, mid))
    rough = rows(mats.roughness, mid)
    sigma = mats.sigma[mid]
    if textures is not None and uv is not None:
        from . import textures as texmod
        ch = mats.tex_channels

        def tex(name, base):
            col = name + "_tex"
            return texmod.apply_tex(textures, getattr(mats, col)[mid], uv, p, base, fp=fp,
                                    ids=mats.tex_ids[col])
        if "kd" in ch:
            kd = tex("kd", kd)
        if "ks" in ch:
            ks = tex("ks", ks)
        if "kr" in ch:
            kr = tex("kr", kr)
        if "kt" in ch:
            kt = tex("kt", kt)
        if "roughness" in ch:
            rough = tex("roughness", torch.cat([rough, rough[..., :1]], -1))[..., :2]
        if "sigma" in ch:
            sigma = tex("sigma", sigma[..., None].expand(*sigma.shape, 3))[..., 0]
    remap = mats.remap_roughness[mid]
    ax = torch.where(remap, bxdf.roughness_to_alpha(rough[..., 0]), rough[..., 0])
    ay = torch.where(remap, bxdf.roughness_to_alpha(rough[..., 1]), rough[..., 1])
    return LaneParams(kind=mats.kind[mid], kd=kd, ks=ks, kr=kr, kt=kt, ax=ax, ay=ay,
                      eta=rows(mats.eta, mid), metal_eta=mats.metal_eta[mid],
                      metal_k=mats.metal_k[mid], sigma=sigma, opacity=mats.opacity[mid],
                      rough_is_zero=rough.amax(-1) < f32(1e-5), aux=mats.aux[mid],
                      fourier=mats.fourier_table)


def average_taps(lps):
    """LaneParams averaged over texture taps: the float fields' mean, kind,
    rough_is_zero and the Fourier table from the first tap."""
    keep = ("kind", "rough_is_zero", "fourier")
    return LaneParams(**{f.name: getattr(lps[0], f.name) if f.name in keep
                         else sum(getattr(lp, f.name) for lp in lps) / len(lps)
                         for f in fields(LaneParams)})


_GGX = bxdf.DIST_GGX


def _fresnel_rgb(eta):
    def fr(c):
        return bxdf.fresnel_dielectric(c, torch.ones_like(eta), eta)[..., None].expand(
            *c.shape, 3)
    return fr


def _conductor(lp):
    return lambda c: bxdf.fresnel_conductor(c, torch.ones_like(lp.eta), lp.metal_eta, lp.metal_k)


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
        lp.ks, _GGX, lp.ax, lp.ay, _fresnel_rgb(lp.eta), wo, wi)


def _plastic_pdf(lp, wo, wi):
    return 0.5 * (bxdf.lambertian_pdf(wo, wi)
                  + bxdf.microfacet_reflection_pdf(_GGX, lp.ax, lp.ay, wo, wi))


def _plastic_sample(lp, wo, u_lobe, u2):
    use_spec = u_lobe < 0.5
    wi_d, _ = bxdf.lambertian_sample(wo, u2)
    wh = bxdf.mf_sample_wh(_GGX, lp.ax, lp.ay, wo, u2)
    wi = torch.where(use_spec[..., None], vm.reflect(wo, wh), wi_d)
    ok = bxdf.same_hemisphere(wo, wi)
    return (wi, torch.where(ok[..., None], _plastic_f(lp, wo, wi), 0.0),
            torch.where(ok, _plastic_pdf(lp, wo, wi), 0.0), None, None)


def _glass_f(lp, wo, wi):
    one = torch.ones_like(lp.eta)
    rough = (bxdf.microfacet_reflection_f(lp.kr, _GGX, lp.ax, lp.ay, _fresnel_rgb(lp.eta),
                                          wo, wi)
             + bxdf.microfacet_transmission_f(lp.kt, _GGX, lp.ax, lp.ay, one, lp.eta, wo, wi))
    return torch.where(lp.rough_is_zero[..., None], 0.0, rough)


def _glass_pdf(lp, wo, wi):
    one = torch.ones_like(lp.eta)
    pdf = 0.5 * (bxdf.microfacet_reflection_pdf(_GGX, lp.ax, lp.ay, wo, wi)
                 + bxdf.microfacet_transmission_pdf(_GGX, lp.ax, lp.ay, one, lp.eta, wo, wi))
    return torch.where(lp.rough_is_zero, 0.0, pdf)


def _glass_sample(lp, wo, u_lobe, u2):
    """Smooth glass: the Fresnel-chosen delta lobes; rough glass: GGX
    reflection or transmission, each with probability 1/2."""
    one = torch.ones_like(lp.eta)
    wi_d, f_d, pdf_d, trans_d = bxdf.fresnel_specular_sample(lp.kr, lp.kt, one, lp.eta, wo,
                                                             u_lobe)
    use_t = u_lobe >= 0.5
    wi_r, _, _ = bxdf.microfacet_reflection_sample(lp.kr, _GGX, lp.ax, lp.ay,
                                                   _fresnel_rgb(lp.eta), wo, u2)
    wi_t, _, _ = bxdf.microfacet_transmission_sample(lp.kt, _GGX, lp.ax, lp.ay, one, lp.eta,
                                                     wo, u2)
    wi_rough = torch.where(use_t[..., None], wi_t, wi_r)
    is0 = lp.rough_is_zero
    return (torch.where(is0[..., None], wi_d, wi_rough),
            torch.where(is0[..., None], f_d, _glass_f(lp, wo, wi_rough)),
            torch.where(is0, pdf_d, _glass_pdf(lp, wo, wi_rough)), is0,
            torch.where(is0, trans_d, use_t & ~bxdf.same_hemisphere(wo, wi_rough)))


def _metal_f(lp, wo, wi):
    return bxdf.microfacet_reflection_f(lp.ks, _GGX, lp.ax, lp.ay, _conductor(lp), wo, wi)


def _metal_pdf(lp, wo, wi):
    return bxdf.microfacet_reflection_pdf(_GGX, lp.ax, lp.ay, wo, wi)


def _metal_sample(lp, wo, u_lobe, u2):
    wi, f, pdf = bxdf.microfacet_reflection_sample(lp.ks, _GGX, lp.ax, lp.ay, _conductor(lp),
                                                   wo, u2)
    return wi, f, pdf, None, None


def _mirror_sample(lp, wo, u_lobe, u2):
    wi, f, pdf = bxdf.specular_reflection_sample(lp.kr, lambda c: torch.ones_like(wo), wo)
    return wi, f, pdf, torch.ones_like(pdf, dtype=torch.bool), None


def _substrate_f(lp, wo, wi):
    return bxdf.fresnel_blend_f(lp.kd, lp.ks, _GGX, lp.ax, lp.ay, wo, wi)


def _substrate_pdf(lp, wo, wi):
    return bxdf.fresnel_blend_pdf(_GGX, lp.ax, lp.ay, wo, wi)


def _substrate_sample(lp, wo, u_lobe, u2):
    wi, f, pdf = bxdf.fresnel_blend_sample(lp.kd, lp.ks, _GGX, lp.ax, lp.ay, wo, u2, u_lobe)
    return wi, f, pdf, None, None


def _translucent_f(lp, wo, wi):
    return (bxdf.lambertian_f(lp.kd * lp.kr, wo, wi)
            + bxdf.lambertian_transmission_f(lp.kd * lp.kt, wo, wi))


def _translucent_pdf(lp, wo, wi):
    return 0.5 * (bxdf.lambertian_pdf(wo, wi) + bxdf.lambertian_transmission_pdf(wo, wi))


def _translucent_sample(lp, wo, u_lobe, u2):
    use_t = u_lobe >= 0.5
    wi_r, _ = bxdf.lambertian_sample(wo, u2)
    wi_t, _ = bxdf.lambertian_transmission_sample(wo, u2)
    wi = torch.where(use_t[..., None], wi_t, wi_r)
    return wi, _translucent_f(lp, wo, wi), _translucent_pdf(lp, wo, wi), None, use_t


def _uber_f(lp, wo, wi):
    return lp.opacity * (bxdf.lambertian_f(lp.kd, wo, wi)
                         + bxdf.microfacet_reflection_f(lp.ks, _GGX, lp.ax, lp.ay,
                                                        _fresnel_rgb(lp.eta), wo, wi))


def _uber_weights(lp):
    wd = luminance(lp.kd)
    ws = luminance(lp.ks)
    wr = luminance(lp.kr) + luminance(1.0 - lp.opacity)
    tot = torch.clamp(wd + ws + wr, min=f32(1e-8))
    return wd / tot, ws / tot, wr / tot


def _uber_pdf(lp, wo, wi):
    wd, ws, _ = _uber_weights(lp)
    return wd * bxdf.lambertian_pdf(wo, wi) \
        + ws * bxdf.microfacet_reflection_pdf(_GGX, lp.ax, lp.ay, wo, wi)


def _uber_sample(lp, wo, u_lobe, u2):
    """u_lobe picks diffuse, glossy or the delta reflection by weight."""
    wd, ws, wr = _uber_weights(lp)
    pick_d = u_lobe < wd
    pick_s = (~pick_d) & (u_lobe < wd + ws)
    pick_r = (~pick_d) & (~pick_s)
    wi_d, _ = bxdf.lambertian_sample(wo, u2)
    fr = _fresnel_rgb(lp.eta)
    wi_s, _, _ = bxdf.microfacet_reflection_sample(lp.ks, _GGX, lp.ax, lp.ay, fr, wo, u2)
    wi_r, f_r, _ = bxdf.specular_reflection_sample(lp.kr, fr, wo)
    wi = torch.where(pick_d[..., None], wi_d, torch.where(pick_s[..., None], wi_s, wi_r))
    f = torch.where(pick_r[..., None], lp.opacity * f_r, _uber_f(lp, wo, wi))
    pdf = torch.where(pick_r, torch.clamp(wr, min=f32(1e-8)), _uber_pdf(lp, wo, wi))
    return wi, f, pdf, pick_r, None


def _disney_args(lp):
    a = lp.aux
    return (lp.kd, a[..., 0], torch.clamp(a[..., 6], min=f32(1e-3)), a[..., 1], a[..., 2],
            a[..., 3], a[..., 4], a[..., 5])


def _disney_f(lp, wo, wi):
    from . import disney
    return disney.disney_f(*_disney_args(lp), wo, wi)


def _disney_pdf(lp, wo, wi):
    from . import disney
    a = lp.aux
    return disney.disney_pdf(torch.clamp(a[..., 6], min=f32(1e-3)), a[..., 0], a[..., 4], wo, wi)


def _disney_sample(lp, wo, u_lobe, u2):
    from . import disney
    wi, f, pdf = disney.disney_sample(*_disney_args(lp), wo, u_lobe, u2)
    return wi, f, pdf, None, None


def _hair_f(lp, wo, wi):
    """Kajiya–Kay hair about the local x axis (the fibre along dpdu)."""
    sin_to = torch.sqrt(torch.clamp(1.0 - wo[..., 0] ** 2, min=0.0))
    sin_ti = torch.sqrt(torch.clamp(1.0 - wi[..., 0] ** 2, min=0.0))
    diffuse = lp.kd * INV_PI * sin_ti[..., None]
    spec_cos = torch.clamp(-wo[..., 0] * wi[..., 0] + sin_to * sin_ti, min=0.0)
    shine = 1.0 / torch.clamp(lp.ax, min=f32(1e-3))
    spec = lp.ks * ((spec_cos ** shine) * (shine + 2.0) / (2.0 * PI))[..., None]
    return diffuse + spec


def _hair_pdf(lp, wo, wi):
    return torch.full_like(wo[..., 0], f32(1.0 / (4.0 * np.float32(np.pi))))


def _hair_sample(lp, wo, u_lobe, u2):
    wi = uniform_sample_sphere(u2)
    return wi, _hair_f(lp, wo, wi), _hair_pdf(lp, wo, wi), None, None


def _fourier_f(lp, wo, wi):
    return fouriermod.fourier_f(lp.fourier, wo, wi)


def _fourier_pdf(lp, wo, wi):
    return torch.where(bxdf.same_hemisphere(wo, wi), wi[..., 2].abs() * INV_PI, 0.0)


def _fourier_sample(lp, wo, u_lobe, u2):
    wi, f, pdf = fouriermod.fourier_sample(lp.fourier, wo, u2)
    return wi, f, pdf, None, ~bxdf.same_hemisphere(wo, wi)


def _zero_f(lp, wo, wi):
    return torch.zeros_like(wo)


def _zero_pdf(lp, wo, wi):
    return torch.zeros_like(wo[..., 0])


# a subsurface surface scatters as smooth or rough glass; the transport
# under it is the integrator's (integrate/path_sss.py)
_F = {MAT_MATTE: _matte_f, MAT_PLASTIC: _plastic_f, MAT_GLASS: _glass_f, MAT_METAL: _metal_f,
      MAT_MIRROR: _zero_f, MAT_SUBSTRATE: _substrate_f, MAT_TRANSLUCENT: _translucent_f,
      MAT_UBER: _uber_f, MAT_DISNEY: _disney_f, MAT_SUBSURFACE: _glass_f, MAT_HAIR: _hair_f,
      MAT_FOURIER: _fourier_f}
_PDF = {MAT_MATTE: _matte_pdf, MAT_PLASTIC: _plastic_pdf, MAT_GLASS: _glass_pdf,
        MAT_METAL: _metal_pdf, MAT_MIRROR: _zero_pdf, MAT_SUBSTRATE: _substrate_pdf,
        MAT_TRANSLUCENT: _translucent_pdf, MAT_UBER: _uber_pdf, MAT_DISNEY: _disney_pdf,
        MAT_SUBSURFACE: _glass_pdf, MAT_HAIR: _hair_pdf, MAT_FOURIER: _fourier_pdf}
_SAMPLE = {MAT_MATTE: _matte_sample, MAT_PLASTIC: _plastic_sample, MAT_GLASS: _glass_sample,
           MAT_METAL: _metal_sample, MAT_MIRROR: _mirror_sample,
           MAT_SUBSTRATE: _substrate_sample, MAT_TRANSLUCENT: _translucent_sample,
           MAT_UBER: _uber_sample, MAT_DISNEY: _disney_sample, MAT_SUBSURFACE: _glass_sample,
           MAT_HAIR: _hair_sample, MAT_FOURIER: _fourier_sample}


def _refuse_mix(kinds_present):
    if MAT_MIX in kinds_present:
        raise ValueError("a mix material has no pdf and no sample (nor has it in the JAX "
                         "package, whose tables lack the entries): a scene with a mix row "
                         "cannot render")


def evaluate_f(lp: LaneParams, kinds_present, wo, wi, _mats=None):
    """BSDF value in the local frame; masked over the kinds present. Mix
    rows blend their two rows' values (aux[0], aux[1], weighted by kd)
    when the table `_mats` is given, and are 0 otherwise."""
    out = torch.zeros_like(wo)
    for k in kinds_present:
        if k != MAT_MIX:
            out = torch.where((lp.kind == k)[..., None], _F[k](lp, wo, wi), out)
    if MAT_MIX in kinds_present and _mats is not None:
        sub_kinds = tuple(k for k in range(12) if k != MAT_MIX)
        f1, f2 = (evaluate_f(resolve(_mats, lp.aux[..., i].to(torch.int64)), sub_kinds, wo, wi)
                  for i in (0, 1))
        out = torch.where((lp.kind == MAT_MIX)[..., None], lp.kd * f1 + (1 - lp.kd) * f2, out)
    return out


def pdf(lp: LaneParams, kinds_present, wo, wi):
    _refuse_mix(kinds_present)
    out = torch.zeros_like(wo[..., 0])
    for k in kinds_present:
        out = torch.where(lp.kind == k, _PDF[k](lp, wo, wi), out)
    return out


def sample(lp: LaneParams, kinds_present, wo, u_lobe, u2):
    """Returns (wi, f, pdf, is_specular, is_transmission)."""
    _refuse_mix(kinds_present)
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
