"""Direct-lighting integrator (counterpart of pbrt_tpu/integrate/direct.py):
one camera hit, its emitted radiance, and MIS next-event estimation with
UniformSampleOne ("one") or UniformSampleAll ("all"). Each estimate
traces its shadow rays through the any-hit kernel and its BSDF-sampled
rays through the closest-hit kernel (common.estimate_direct)."""
from __future__ import annotations

import torch

from ..core import samplers as smp
from ..geom import scene as scenemod
from ..lights import lights as lightsmod
from ..shade import materials as matmod
from . import common


def li(scene, o, d, pixel_id, sample_idx, cfg, strategy="one", return_stats=False):
    """Radiance along camera rays o, d (..., 3) for lanes (pixel_id,
    sample_idx). strategy: "one" | "all". Returns L (..., 3), and with
    `return_stats` also {"rays_traced": scalar tensor}: every camera ray,
    the usable shadow rays and the used BSDF rays (path.li's count)."""
    if strategy not in ("one", "all"):
        raise ValueError(f"strategy {strategy!r}: expected 'one' or 'all'")
    shp = pixel_id.shape
    pixel_id, sample_idx, o, d = common.flat_lanes(pixel_id, sample_idx, o, d)
    lights = scene.lights
    hit = scenemod.intersect(scene, o, d)
    wo = -d
    l_emit = torch.where(hit.valid[..., None],
                         lightsmod.area_light_radiance(lights, hit.light_id, hit.ng, wo),
                         lightsmod.env_radiance(lights, d))
    frame = common.shading_frame(hit, scene)
    lp = matmod.resolve(scene.materials, hit.material_id, hit.uv, hit.p, scene.textures)
    kinds = scene.materials.kinds_present
    active = hit.valid & (hit.material_id >= 0)

    def u(n, slot):
        fn = smp.sample_1d if n == 1 else smp.sample_2d
        return fn(cfg.sampler, pixel_id, sample_idx, smp.bounce_dim(0, slot))

    def estimate(lt, pmf):
        return common.estimate_direct(scene, lights, lp, kinds, frame, hit.p, hit.ns,
                                      hit.ng, wo, lt, pmf, u(2, 3), u(2, 0), u(1, 2),
                                      active, return_rays=True)

    rays_traced = torch.full((), float(pixel_id.numel()), device=o.device)
    if strategy == "all":
        ld = torch.zeros_like(o)
        ones = torch.ones(pixel_id.shape, dtype=torch.float32, device=o.device)
        for l_idx in range(int(lights.count)):
            ld_l, rays = estimate(torch.full_like(pixel_id, l_idx), ones)
            ld, rays_traced = ld + ld_l, rays_traced + rays
    else:
        ld, rays = estimate(*common.select_light_uniform(lights, u(1, 5)))
        rays_traced = rays_traced + rays
    L = (l_emit + torch.where(active[..., None], ld, 0.0)).reshape(shp + (3,))
    return (L, {"rays_traced": rays_traced}) if return_stats else L


def make_li(cfg, strategy="one", return_stats=False):
    return lambda scene, o, d, pid, sid: li(scene, o, d, pid, sid, cfg, strategy,
                                            return_stats)
