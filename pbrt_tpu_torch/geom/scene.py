"""Scene and the top-level intersection queries for the triangle pool
(counterpart of pbrt_tpu/geom/scene.py: intersect, occluded and
intersect_occluded). With clusters the tile×cluster tracer runs — each
path bounce traces its extension and shadow rays in one fused launch, a
standalone shadow query runs the any-hit kernel; without clusters the
brute-force tracers run. Quadrics and instances are not ported: the
scene holds triangles only, and bridge.scene_from_numpy refuses a scene
that carries them."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from ..core.types import INF, RAY_EPS
from . import cluster as clmod
from . import triangle as trimod
from .types import Hit, TriangleSoA


@dataclass
class Scene:
    tri: TriangleSoA
    clusters: Optional[clmod.ClusterSet]
    materials: Any               # shade.materials.MaterialTable
    lights: Any                  # lights.lights.LightTable
    textures: Any                # shade.textures.TextureTable or None
    world_center: torch.Tensor   # (3,)
    world_radius: float
    tile: int = clmod.TILE       # rays per tracer tile

    @property
    def device(self):
        return self.tri.positions.device


def _window(n, active, device):
    t_min = torch.full((n,), RAY_EPS, dtype=torch.float32, device=device)
    t_max = torch.full((n,), INF, dtype=torch.float32, device=device)
    if active is not None:
        t_max = torch.where(active, t_max, -1.0)
    return t_min, t_max


def hit_from_triangles(scene: Scene, d, t_max, result) -> Hit:
    """Hit record from a triangle-pool trace result (hit, t, idx, b1, b2)."""
    t_hit, t_t, t_idx, b1, b2 = result
    p, ng, ns, uv, dpdu, uvs, mat_id, light_id = trimod.shading_from_rec(
        scene.tri, t_idx, b1, b2)
    take = t_hit & (t_t < t_max)
    t3 = take[..., None]
    return Hit(valid=take, t=torch.where(take, t_t, INF),
               p=torch.where(t3, p, 0.0), ng=torch.where(t3, ng, 0.0),
               ns=torch.where(t3, ns, 0.0), uv=torch.where(t3, uv, 0.0),
               dpdu=torch.where(t3, dpdu, 0.0), wo=-d,
               material_id=torch.where(take, mat_id, -1),
               light_id=torch.where(take, light_id, -1),
               prim_kind=torch.zeros_like(mat_id),
               prim_id=torch.where(take, t_idx, -1),
               uv_scale=torch.where(take, uvs, 1.0))


def intersect(scene: Scene, o, d, active=None) -> Hit:
    """Closest hit for rays o, d (N, 3); `active` marks live lanes (dead
    lanes get t_max < t_min and cost the tracer nothing)."""
    t_min, t_max = _window(o.shape[0], active, o.device)
    if scene.clusters is not None:
        res = clmod.intersect(scene.clusters, o, d, t_min, t_max, scene.tile)
    else:
        res = trimod.intersect_brute(scene.tri, o, d, t_min, t_max)
    return hit_from_triangles(scene, d, t_max, res)


def occluded(scene: Scene, o, d, t_min=None, t_max=None, active=None):
    """Any-hit (shadow) query for rays o, d (N, 3) with t in (t_min, t_max)
    (defaults RAY_EPS and INF; scalars or (N,)). Dead lanes (`active`
    false) get t_max = -1. Returns occ (N,) bool."""
    n = o.shape[0]
    f = dict(dtype=torch.float32, device=o.device)
    t_min = torch.broadcast_to(torch.as_tensor(RAY_EPS if t_min is None else t_min, **f), (n,))
    t_max = torch.broadcast_to(torch.as_tensor(INF if t_max is None else t_max, **f), (n,))
    if active is not None:
        t_max = torch.where(active, t_max, -1.0)
    if scene.clusters is not None:
        return clmod.occluded(scene.clusters, o, d, t_min, t_max, scene.tile)
    return trimod.occluded_brute(scene.tri, o, d, t_min, t_max)


def intersect_occluded(scene: Scene, o, d, o_sh, d_sh, tmax_sh, active=None,
                       active_sh=None):
    """Fused closest hit (o, d) and shadow query (o_sh, d_sh) with t in
    (RAY_EPS, tmax_sh). Returns (Hit, occ)."""
    t_min, t_max = _window(o.shape[0], active, o.device)
    tmin_sh = torch.full_like(tmax_sh, RAY_EPS)
    if active_sh is not None:
        tmax_sh = torch.where(active_sh, tmax_sh, -1.0)
    if scene.clusters is not None:
        res, occ = clmod.intersect_occluded(scene.clusters, o, d, t_min, t_max,
                                            o_sh, d_sh, tmin_sh, tmax_sh, scene.tile)
    else:
        res = trimod.intersect_brute(scene.tri, o, d, t_min, t_max)
        occ = trimod.occluded_brute(scene.tri, o_sh, d_sh, tmin_sh, tmax_sh)
    return hit_from_triangles(scene, d, t_max, res), occ
