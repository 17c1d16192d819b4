"""Whitted integrator (counterpart of pbrt_tpu/integrate/whitted.py: `li`):
at each hit, emission and next-event estimation from every light; the
path continues only along a specular lobe (mirror, smooth glass).

Per depth: one closest-hit trace, then one any-hit trace per light row.
"""
from __future__ import annotations

import torch

from ..core import samplers as smp
from ..core import vecmath as vm
from ..core.spectrum import luminance
from ..core.types import f32
from ..geom import scene as scenemod
from ..lights import lights as lightsmod
from ..shade import materials as matmod
from . import common


def li(scene, o, d, pixel_id, sample_idx, cfg, return_stats=False):
    """Radiance along camera rays o, d (..., 3) for lanes (pixel_id,
    sample_idx). Returns L (..., 3), and with `return_stats` also
    {"rays_traced": scalar tensor}: the rays of live lanes and the usable
    shadow rays."""
    lights = scene.lights
    kinds = scene.materials.kinds_present
    shp = pixel_id.shape
    dev = o.device
    pixel_id, sample_idx, o, d = common.flat_lanes(pixel_id, sample_idx, o, d)
    n = pixel_id.numel()
    L = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    beta = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    rays_traced = torch.zeros((), dtype=torch.float32, device=dev)

    for depth in range(cfg.max_depth):
        hit = scenemod.intersect(scene, o, d, active=active)
        rays_traced = rays_traced + active.to(torch.float32).sum()
        wo = -d
        le = torch.where(hit.valid[..., None],
                         lightsmod.area_light_radiance(lights, hit.light_id, hit.ng, wo),
                         lightsmod.env_radiance(lights, d))
        L = L + torch.where(active[..., None], beta * le, 0.0)
        active = active & hit.valid & (hit.material_id >= 0)

        frame = common.shading_frame(hit)
        lp = matmod.resolve(scene.materials, hit.material_id, hit.uv, hit.p, scene.textures)
        wo_l = frame.to_local(wo)

        # every light's sample, each shadow ray through the any-hit query
        ld = torch.zeros_like(L)
        for l_idx in range(int(lights.count)):
            lt = torch.full((n,), l_idx, dtype=torch.int64, device=dev)
            u_light = smp.sample_2d(cfg.sampler, pixel_id, sample_idx,
                                    smp.bounce_dim(depth, 3) + 10 * l_idx)
            ls = lightsmod.sample_li(lights, scene, lt, hit.p, u_light, scene.world_radius)
            f = matmod.evaluate_f(lp, kinds, wo_l, frame.to_local(ls["wi"])) \
                * vm.absdot(ls["wi"], hit.ns)[..., None]
            usable = active & (ls["pdf"] > 0) & (luminance(f) > 0)
            o_sh, wi, t_max = common.shadow_ray(ls, hit.p, hit.ng)
            occ = scenemod.occluded(scene, o_sh, wi, t_max=t_max, active=usable)
            rays_traced = rays_traced + usable.to(torch.float32).sum()
            ld = ld + torch.where((usable & ~occ)[..., None],
                                  f * ls["li"] / torch.clamp(ls["pdf"], min=f32(1e-12))[..., None],
                                  0.0)
        L = L + torch.where(active[..., None], beta * ld, 0.0)

        # the specular continuation only
        u_bsdf = smp.sample_2d(cfg.sampler, pixel_id, sample_idx, smp.bounce_dim(depth, 0))
        u_lobe = smp.sample_1d(cfg.sampler, pixel_id, sample_idx, smp.bounce_dim(depth, 2))
        wi_l, f, pdf, spec, _ = matmod.sample(lp, kinds, wo_l, u_lobe, u_bsdf)
        wi = frame.to_world(wi_l)
        cont = active & spec & (pdf > 0.0) & (luminance(f) > 0.0)
        beta = torch.where(cont[..., None],
                           beta * f * (vm.absdot(wi, hit.ns)
                                       / torch.clamp(pdf, min=f32(1e-12)))[..., None], beta)
        active = cont
        o = vm.offset_ray_origin(hit.p, hit.ng, wi)
        d = wi
    L = L.reshape(shp + (3,))
    if return_stats:
        return L, {"rays_traced": rays_traced}
    return L


def make_li(cfg, return_stats=False):
    return lambda scene, o, d, pid, sid: li(scene, o, d, pid, sid, cfg,
                                            return_stats=return_stats)
