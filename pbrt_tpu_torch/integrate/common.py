"""Shading frames, light selection and MIS next-event estimation
(counterpart of pbrt_tpu/integrate/common.py): the light-sampling half
with its shadow ray deferred (path) or traced through the any-hit kernel
(`nee_light_part`, `estimate_direct`), and the BSDF-sampling half."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..core.sampling import power_heuristic
from ..core.spectrum import luminance
from ..core.types import SHADOW_EPS, divisor, f32
from ..geom import scene as scenemod
from ..lights import distrib
from ..lights import lights as lightsmod
from ..shade import materials as matmod

STRATEGIES = ("uniform", "power", "spatial")


class Frame(NamedTuple):
    t: torch.Tensor
    b: torch.Tensor
    n: torch.Tensor

    def to_local(self, v):
        return vm.to_local(v, self.t, self.b, self.n)

    def to_world(self, v):
        return vm.to_world(v, self.t, self.b, self.n)


def flat_lanes(pixel_id, sample_idx, o, d):
    """Lanes of any leading shape as flat (N,) ids and (N, 3) rays."""
    n = pixel_id.numel()
    sample_idx = torch.broadcast_to(torch.as_tensor(sample_idx, device=o.device),
                                    pixel_id.shape)
    return pixel_id.reshape(n), sample_idx.reshape(n), o.reshape(n, 3), d.reshape(n, 3)


BUMP_DU = f32(5e-4)     # the bump texture's finite-difference step in u, v and p


def shading_frame(hit, scene=None):
    """Orthonormal shading frame from the hit's dpdu and shading normal,
    bump-mapped where the hit's material has a bump texture and `scene`
    is given: the normal tilts by the texture's finite differences along
    u (dpdu) and v (n × dpdu)."""
    t, n = hit.dpdu, hit.ns
    mats = None if scene is None else scene.materials
    if mats is not None and scene.textures is not None and mats.has_bump:
        from ..shade import textures as texmod
        btex = mats.bump_tex[torch.clamp(hit.material_id, min=0)]
        b_axis = vm.normalize(vm.cross(n, t))
        du = BUMP_DU
        step = torch.tensor([[du, 0.0], [0.0, du]], dtype=torch.float32, device=t.device)
        ids = mats.tex_ids["bump_tex"]
        h0, hu, hv = (texmod.evaluate(scene.textures, btex, uv, p, ids=ids)[..., 0]
                      for uv, p in ((hit.uv, hit.p), (hit.uv + step[0], hit.p + du * t),
                                    (hit.uv + step[1], hit.p + du * b_axis)))
        dudiv = divisor(du, t.device)
        dhdu = (hu - h0) / dudiv
        dhdv = (hv - h0) / dudiv
        n_b = vm.normalize(n - dhdu[..., None] * t - dhdv[..., None] * b_axis)
        n = torch.where((btex >= 0)[..., None], n_b, n)
        t = vm.normalize(t - vm.dot(t, n)[..., None] * n)
    b = vm.normalize(vm.cross(n, t))
    return Frame(vm.cross(b, n), b, n)


def select_light_uniform(lights, u):
    """(light index, pmf): UniformSampleOne."""
    n = lights.count
    idx = torch.clamp((u * n).to(torch.int64), max=n - 1)
    return idx, torch.full_like(u, 1.0 / n)


def _strategy(scene, strategy):
    """The strategy that runs: "spatial" needs the scene's grid and
    falls back to "uniform" without one, as in the reference."""
    if strategy not in STRATEGIES:
        raise ValueError(f"light strategy {strategy!r}: expected one of {STRATEGIES}")
    if strategy == "spatial" and scene.light_distrib is None:
        return "uniform"
    return strategy


def select_light(scene, strategy, p, u):
    """A light per lane by strategy "uniform", "power" or "spatial".
    Returns (light index, pmf)."""
    strategy = _strategy(scene, strategy)
    if strategy == "power":
        idx, pmf, _ = scene.light_power.sample_discrete(u)
        return idx, pmf
    if strategy == "spatial":
        return distrib.spatial_lookup_sample(scene.light_distrib, p, u)
    return select_light_uniform(scene.lights, u)


def select_light_pmf(scene, strategy, p, light_id):
    """pmf the selection strategy gives `light_id` at p."""
    strategy = _strategy(scene, strategy)
    nl = max(int(scene.lights.count), 1)
    if strategy == "power":
        dist = scene.light_power
        return dist.func[torch.clamp(light_id, min=0)] / torch.clamp(dist.func_int * nl,
                                                                     min=f32(1e-20))
    if strategy == "spatial":
        func = scene.light_distrib.grid_func[distrib.voxel_of(scene.light_distrib, p)]
        return torch.gather(func, -1, torch.clamp(light_id, min=0)[..., None])[..., 0] \
            / torch.clamp(func.sum(-1), min=f32(1e-20))
    return torch.full(light_id.shape, 1.0 / nl, dtype=torch.float32, device=light_id.device)


def shadow_ray(ls, p, ng):
    """The shadow ray toward a light sample: origin offset along ng toward
    wi, t_max just short of the sample so the light does not occlude
    itself. Returns (o_sh, wi, t_max)."""
    wi = ls["wi"]
    return (vm.offset_ray_origin(p, ng, wi), wi,
            torch.clamp(ls["dist"] * f32(1.0 - 1e-3), min=SHADOW_EPS))


def nee_light_defer(scene, lights, lp, kinds_present, frame, p, ns, ng, wo, lt,
                    u_light, active):
    """Light-sampling half of MIS direct lighting without the shadow
    trace. Returns (contrib, o_sh, wi, tmax_sh, usable, ls); the caller
    traces the shadow ray (fused into the bounce's extension launch) and
    applies contrib where unoccluded."""
    ls = lightsmod.sample_li(lights, scene, lt, p, u_light, scene.world_radius)
    wi = ls["wi"]
    wo_l = frame.to_local(wo)
    wi_l = frame.to_local(wi)
    f = matmod.evaluate_f(lp, kinds_present, wo_l, wi_l) * vm.absdot(wi, ns)[..., None]
    scat_pdf = matmod.pdf(lp, kinds_present, wo_l, wi_l)
    usable = active & (ls["pdf"] > 0.0) & (luminance(ls["li"]) > 0.0) & (luminance(f) > 0.0)
    o_sh, _, tmax_sh = shadow_ray(ls, p, ng)
    w_l = torch.where(ls["is_delta"], 1.0, power_heuristic(1.0, ls["pdf"], 1.0, scat_pdf))
    contrib = f * ls["li"] * (w_l / torch.clamp(ls["pdf"], min=f32(1e-12)))[..., None]
    contrib = torch.where(usable[..., None], contrib, 0.0)
    return contrib, o_sh, wi, tmax_sh, usable, ls


def nee_light_part(scene, lights, lp, kinds_present, frame, p, ns, ng, wo, lt,
                   u_light, active):
    """Light-sampling half of MIS direct lighting, its shadow ray traced
    through scene.occluded. Returns (ld_light (N, 3), not divided by the
    selection pmf, ls)."""
    contrib, o_sh, wi, tmax_sh, usable, ls = nee_light_defer(
        scene, lights, lp, kinds_present, frame, p, ns, ng, wo, lt, u_light, active)
    occ = scenemod.occluded(scene, o_sh, wi, t_max=tmax_sh, active=usable)
    return torch.where((usable & ~occ)[..., None], contrib, 0.0), ls


def nee_bsdf_ray(lp, kinds_present, frame, p, ns, ng, wo, u_lobe, u_bsdf):
    """Sample the MIS BSDF ray. Returns (o_b, wi_b, f_b·|cos|, pdf_b, spec_b)."""
    wo_l = frame.to_local(wo)
    wi_b_l, f_b, pdf_b, spec_b, _ = matmod.sample(lp, kinds_present, wo_l, u_lobe, u_bsdf)
    wi_b = frame.to_world(wi_b_l)
    f_b = f_b * vm.absdot(wi_b, ns)[..., None]
    return vm.offset_ray_origin(p, ng, wi_b), wi_b, f_b, pdf_b, spec_b


def bsdf_ray_used(ls, pdf_b, f_b, spec_b, active):
    """Lanes whose BSDF-sampled ray can carry the light's MIS share."""
    return active & ~ls["is_delta"] & ~spec_b & (pdf_b > 0.0) & (luminance(f_b) > 0.0)


def nee_bsdf_part(scene, lights, ls, lt, p, wi_b, f_b, pdf_b, spec_b, hit_b, active):
    """BSDF-sampling half of MIS direct lighting given the traced hit:
    the light's share where the BSDF ray hit that area light, or escaped
    while the sampled light is the infinite one. Returns ld_bsdf (N, 3),
    not divided by the selection pmf."""
    try_bsdf = bsdf_ray_used(ls, pdf_b, f_b, spec_b, active)
    same_light = hit_b.valid & (hit_b.light_id == lt)
    li_surf = lightsmod.area_light_radiance(lights, hit_b.light_id, hit_b.ng, -wi_b)
    pdf_light_b = lightsmod.pdf_li_area_scene(lights, scene, lt, p, hit_b.p, hit_b.ng)
    li_b = torch.where(same_light[..., None], li_surf, 0.0)
    pdf_light_b = torch.where(same_light, pdf_light_b, 0.0)
    got_light = same_light
    if lights.env_index >= 0:
        env = ~hit_b.valid & (lt == lights.env_index)
        li_b = torch.where(env[..., None], lightsmod.env_radiance(lights, wi_b), li_b)
        pdf_light_b = torch.where(env, lightsmod.env_pdf_li(lights, wi_b), pdf_light_b)
        got_light = env | same_light
    w_b = power_heuristic(1.0, pdf_b, 1.0, pdf_light_b)
    contrib_b = f_b * li_b * (w_b / torch.clamp(pdf_b, min=f32(1e-12)))[..., None]
    ok_b = try_bsdf & got_light & (pdf_light_b > 0.0)
    return torch.where(ok_b[..., None], contrib_b, 0.0)


def estimate_direct(scene, lights, lp, kinds_present, frame, p, ns, ng, wo, lt, lt_pmf,
                    u_light, u_bsdf, u_lobe, active, return_rays=False):
    """MIS direct lighting for one sampled light per lane: the shadow ray
    through scene.occluded (the any-hit kernel), the BSDF-sampled ray
    through scene.intersect (the closest-hit kernel), both over every
    lane as in the reference. Returns (N, 3) radiance divided by the
    light-selection pmf, and with `return_rays` also the rays that carry
    a share (usable shadow rays and used BSDF rays, a scalar tensor)."""
    contrib, o_sh, wi, t_max, usable, ls = nee_light_defer(
        scene, lights, lp, kinds_present, frame, p, ns, ng, wo, lt, u_light, active)
    occ = scenemod.occluded(scene, o_sh, wi, t_max=t_max)
    ld = torch.where((usable & ~occ)[..., None], contrib, 0.0)

    o_b, wi_b, f_b, pdf_b, spec_b = nee_bsdf_ray(lp, kinds_present, frame, p, ns, ng, wo,
                                                 u_lobe, u_bsdf)
    hit_b = scenemod.intersect(scene, o_b, wi_b)
    ld = ld + nee_bsdf_part(scene, lights, ls, lt, p, wi_b, f_b, pdf_b, spec_b, hit_b,
                            active)
    ld = ld / torch.clamp(lt_pmf, min=f32(1e-12))[..., None]
    if return_rays:
        used = bsdf_ray_used(ls, pdf_b, f_b, spec_b, active)
        return ld, (usable.to(torch.float32).sum() + used.to(torch.float32).sum())
    return ld
