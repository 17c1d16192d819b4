"""Ambient-occlusion integrator (counterpart of pbrt_tpu/integrate/ao.py):
one camera hit and `n_samples` cosine- or uniform-hemisphere occlusion
rays, each sample a full-width shadow query through the any-hit kernel
with t_max = 2·world_radius."""
from __future__ import annotations

import torch

from ..core import samplers as smp
from ..core import vecmath as vm
from ..core.sampling import cosine_sample_hemisphere, uniform_sample_hemisphere
from ..core.types import INV_PI, PI, f32
from ..geom import scene as scenemod
from . import common


def li(scene, o, d, pixel_id, sample_idx, cfg, cos_sample=True, n_samples=4,
       return_stats=False):
    """Occlusion-weighted radiance (the same value in all three channels)
    along camera rays o, d (..., 3). Returns (..., 3), and with
    `return_stats` also {"rays_traced": scalar tensor}: every camera ray
    and the occlusion rays of lanes with a surface hit (path.li's count)."""
    shp = pixel_id.shape
    pixel_id, sample_idx, o, d = common.flat_lanes(pixel_id, sample_idx, o, d)
    hit = scenemod.intersect(scene, o, d)
    frame = common.shading_frame(hit)
    acc = torch.zeros(pixel_id.shape, dtype=torch.float32, device=o.device)
    for s in range(n_samples):
        u = smp.sample_2d(cfg.sampler, pixel_id, sample_idx, smp.bounce_dim(0, 0) + 2 * s)
        if cos_sample:
            wi_l = cosine_sample_hemisphere(u)
            pdf = torch.clamp(wi_l[..., 2] * INV_PI, min=f32(1e-8))
        else:
            wi_l = uniform_sample_hemisphere(u)
            pdf = torch.full(u.shape[:-1], f32(1.0 / (2.0 * PI)), dtype=torch.float32,
                             device=o.device)
        wi = frame.to_world(wi_l)
        o_sh = vm.offset_ray_origin(hit.p, hit.ng, wi)
        occ = scenemod.occluded(scene, o_sh, wi, t_max=f32(2.0 * scene.world_radius))
        acc = acc + torch.where(hit.valid & ~occ, wi_l[..., 2] * INV_PI / pdf, 0.0)
    L = (acc / n_samples)[..., None].expand(*acc.shape, 3).reshape(shp + (3,))
    if return_stats:
        rays = pixel_id.numel() + n_samples * hit.valid.to(torch.float32).sum()
        return L, {"rays_traced": rays}
    return L


def make_li(cfg, cos_sample=True, n_samples=4, return_stats=False):
    return lambda scene, o, d, pid, sid: li(scene, o, d, pid, sid, cfg, cos_sample,
                                            n_samples, return_stats)
