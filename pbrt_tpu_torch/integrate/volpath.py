"""Volumetric path tracer (counterpart of pbrt_tpu/integrate/volpath.py:
`li`).

    hit = closest_hit(primary)
    for bounce < max_depth:
        sample a medium event on the segment to `hit`
        emission pickup at `hit` for lanes the medium did not stop
        medium event: NEE (phase × Tr) and one HG phase sample
        surface event: NEE (BSDF × Tr) and one BSDF sample
        the lane continues from its one event; a transmission through a
            surface with a medium interface switches the lane's medium
        Russian roulette from bounce `rr_start`
        one fused launch: N extension rays and 2N shadow rays (medium
            and surface NEE)
    final segment: Tr × emission pickup

The one direction sample per vertex (phase or BSDF) is both the MIS
counterpart of that vertex's light sample and its continuation, as in
path.li. Every lane starts in medium 0 when the scene has media. No
compaction: every launch is full width, as in the reference.

Spans as path.li's for the same work (driver.li, driver.bounce,
lights.nee, shading.material, shading.bsdf), the media layer's from
shade/media.py. While recording, and only then, each bounce counts
`media.lanes` (the active lanes given a free flight) and `media.events`
(those it stopped in the medium): two device scalars, two reductions.
"""
from __future__ import annotations

import torch

from .. import trace
from ..core import samplers as smp
from ..core import vecmath as vm
from ..core.rng import hash_combine
from ..core.sampling import power_heuristic
from ..core.spectrum import luminance
from ..core.types import SHADOW_EPS, f32
from ..geom import scene as scenemod
from ..lights import lights as lightsmod
from ..shade import materials as matmod
from ..shade import media as medmod
from . import common
from .path import _emission_pickup

# dimension offsets past the shared per-bounce slots, so the medium's
# streams do not collide with the surface's
_DIM_MED_CH = 1000      # channel selection (1D)
_DIM_PHASE = 2000       # phase direction (2D)
_DIM_MED_SEL = 3000     # medium-event light selection (1D)
_DIM_MED_LIGHT = 3001   # medium-event light sample (2D)


@trace.spanned("driver.li")
def li(scene, o, d, pixel_id, sample_idx, cfg, rr_start=3, return_stats=False):
    """Radiance along camera rays o, d (..., 3) for lanes (pixel_id,
    sample_idx). Returns L (..., 3), and with `return_stats` also
    {"rays_traced": scalar tensor}: camera rays, live extension rays and
    the usable shadow rays of both kinds."""
    lights, media = scene.lights, scene.media
    kinds = scene.materials.kinds_present
    shp = pixel_id.shape
    dev = o.device
    pixel_id, sample_idx, o, d = common.flat_lanes(pixel_id, sample_idx, o, d)
    n = pixel_id.numel()

    def s1(bounce, slot, extra=0):
        return smp.sample_1d(cfg.sampler, pixel_id, sample_idx,
                             smp.bounce_dim(bounce, slot) + extra)

    def s2(bounce, slot, extra=0):
        return smp.sample_2d(cfg.sampler, pixel_id, sample_idx,
                             smp.bounce_dim(bounce, slot) + extra)

    f3 = dict(dtype=torch.float32, device=dev)
    L = torch.zeros((n, 3), **f3)
    beta = torch.ones((n, 3), **f3)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_spec = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), **f3)
    prev_p = o
    cur_med = torch.full((n,), 0 if media is not None else -1, dtype=torch.int64, device=dev)
    far = f32(2.0 * scene.world_radius)
    iface = scene.materials.med_inside is not None and media is not None

    hit = scenemod.intersect(scene, o, d, active=active)
    rays_traced = torch.zeros((), **f3) + n
    for bounce in range(cfg.max_depth):
        with trace.span("driver.bounce"):
            wo = -d
            seg_dist = torch.where(hit.valid, hit.t, far)

            # medium interaction on this segment
            key = hash_combine(pixel_id, sample_idx, 37 + bounce)
            m_sampled, m_t, m_w = medmod.medium_sample(media, cur_med, o, d, seg_dist,
                                                       s1(bounce, 7),
                                                       s1(bounce, 7, _DIM_MED_CH), key)
            m_sampled = m_sampled & active
            if trace.on():
                trace.count("media.lanes", active.sum())
                trace.count("media.events", m_sampled.sum())
            beta = torch.where(active[..., None], beta * m_w, beta)
            p_med = o + m_t[..., None] * d

            # emission at the surface vertex, for lanes the medium did not stop
            reach = active & ~m_sampled
            L = L + beta * _emission_pickup(scene, lights, cfg, hit, d, prev_p, prev_pdf,
                                            prev_spec, reach)

            # medium event: NEE light half (HG's pdf is its value) and a phase sample
            g = medmod.phase_g(media, cur_med)
            with trace.span("lights.nee"):
                lt_m, pmf_m = common.select_light(scene, cfg.light_strategy, p_med,
                                                  s1(bounce, 5, _DIM_MED_SEL))
                ls_m = lightsmod.sample_li(lights, scene, lt_m, p_med,
                                           s2(bounce, 5, _DIM_MED_LIGHT), scene.world_radius)
                ph_l = medmod.hg_phase(vm.dot(wo, ls_m["wi"]), g)
                tr_m = medmod.medium_tr(media, cur_med, p_med, ls_m["wi"], ls_m["dist"],
                                        hash_combine(pixel_id, sample_idx, 91 + bounce))
                w_lm = torch.where(ls_m["is_delta"], 1.0,
                                   power_heuristic(1.0, ls_m["pdf"], 1.0, ph_l))
                ld_med = ls_m["li"] * tr_m \
                    * (ph_l * w_lm / torch.clamp(ls_m["pdf"], min=f32(1e-12)))[..., None] \
                    / torch.clamp(pmf_m, min=f32(1e-12))[..., None]
                usable_m = m_sampled & (ls_m["pdf"] > 0)
                tmax_m = torch.clamp(ls_m["dist"] * f32(1.0 - 1e-3), min=SHADOW_EPS)
                nee_med = torch.where(usable_m[..., None], beta * ld_med, 0.0)
            # drawn about wo, as PBRT's HenyeyGreenstein::Sample_p draws it, so
            # that wi's density is hg_phase(wo . wi), the value NEE weighs
            wi_med, ph_pdf = medmod.hg_sample(wo, g, s2(bounce, 0, _DIM_PHASE))

            # surface event: NEE with Tr over the shadow segment, one BSDF sample
            surf = reach & hit.valid & (hit.material_id >= 0)
            with trace.span("shading.material"):
                frame = common.shading_frame(hit, scene)
                lp = matmod.resolve(scene.materials, hit.material_id, hit.uv, hit.p,
                                    scene.textures)
            with trace.span("lights.nee"):
                lt_s, pmf_s = common.select_light(scene, cfg.light_strategy, hit.p,
                                                  s1(bounce, 5))
                ld_surf_c, o_sh_s, wi_sh_s, tmax_s, usable_s, ls_s = common.nee_light_defer(
                    scene, lights, lp, kinds, frame, hit.p, hit.ns, hit.ng, wo, lt_s,
                    s2(bounce, 3), surf)
                tr_s = medmod.medium_tr(media, cur_med, hit.p, ls_s["wi"], ls_s["dist"],
                                        hash_combine(pixel_id, sample_idx, 121 + bounce))
                nee_surf = torch.where(surf[..., None], beta * ld_surf_c * tr_s
                                       / torch.clamp(pmf_s, min=f32(1e-12))[..., None], 0.0)
            with trace.span("shading.bsdf"):
                wi_l, f, pdf, spec, trans = matmod.sample(lp, kinds, frame.to_local(wo),
                                                          s1(bounce, 2), s2(bounce, 0))
                wi_surf = frame.to_world(wi_l)
                good_surf = surf & (pdf > 0.0) & (luminance(f) > 0.0)
                beta = torch.where(good_surf[..., None],
                                   beta * f * (vm.absdot(wi_surf, hit.ns)
                                               / torch.clamp(pdf, min=f32(1e-12)))[..., None],
                                   beta)

                # merge the continuations
                m3 = m_sampled[..., None]
                active = m_sampled | good_surf
                prev_spec = torch.where(m_sampled, False, spec)
                prev_pdf = torch.where(m_sampled, ph_pdf, pdf)
                prev_p = torch.where(m3, p_med, hit.p)
                o = torch.where(m3, p_med, vm.offset_ray_origin(hit.p, hit.ng, wi_surf))
                d = torch.where(m3, wi_med, wi_surf)
                if iface:       # transmission through an interface switches the medium
                    midx = torch.clamp(hit.material_id, min=0)
                    entering = vm.dot(wi_surf, hit.ng) < 0.0
                    new_med = torch.where(entering, scene.materials.med_inside[midx],
                                          scene.materials.med_outside[midx])
                    cur_med = torch.where(good_surf & trans, new_med, cur_med)

                if bounce >= rr_start:
                    q = torch.clamp(1.0 - vm.max_component(beta), min=f32(0.05))
                    survive = s1(bounce, 6) >= q
                    beta = torch.where((active & survive)[..., None],
                                       beta / torch.clamp(1.0 - q, min=f32(1e-6))[..., None],
                                       beta)
                    active = active & survive

            # one fused launch: the extension rays and both shadow wavefronts
            usable_sh = torch.cat([usable_m, usable_s])
            hit, occ = scenemod.intersect_occluded(
                scene, o, d, torch.cat([p_med, o_sh_s]), torch.cat([ls_m["wi"], wi_sh_s]),
                torch.cat([tmax_m, tmax_s]), active=active, active_sh=usable_sh)
            L = L + torch.where((usable_m & ~occ[:n])[..., None], nee_med, 0.0)
            L = L + torch.where((usable_s & ~occ[n:])[..., None], nee_surf, 0.0)
            rays_traced = rays_traced + usable_sh.to(torch.float32).sum() \
                + active.to(torch.float32).sum()

    # the last segment: Tr and the emission the last extension rays found
    seg_dist = torch.where(hit.valid, hit.t, far)
    tr_f = medmod.medium_tr(media, cur_med, o, d, seg_dist,
                            hash_combine(pixel_id, sample_idx, 191))
    L = L + beta * tr_f * _emission_pickup(scene, lights, cfg, hit, d, prev_p, prev_pdf,
                                           prev_spec, active)
    L = L.reshape(shp + (3,))
    if return_stats:
        return L, {"rays_traced": rays_traced}
    return L


def make_li(cfg, rr_start=3, return_stats=False):
    return lambda scene, o, d, pid, sid: li(scene, o, d, pid, sid, cfg, rr_start,
                                            return_stats=return_stats)
