"""Scene and the top-level intersection queries (counterpart of
pbrt_tpu/geom/scene.py: make_scene's world bounds, intersect, occluded
and intersect_occluded). The triangle pool runs through the tile×cluster
tracer when the scene has clusters — each path bounce traces its
extension and shadow rays in one fused launch, a standalone shadow query
runs the any-hit kernel — else through the BVH when it has one, else
through the brute-force tracers. The quadric pool runs brute force after
it, with the triangles' nearest t as its window; then each instance set
(geom/instances.py), its pairs of (instance, lane) traced as one
object-space wavefront, at the lanes' shutter times (`time`, None for the
shutter open)."""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .. import trace
from ..core.types import INF, RAY_EPS, f32
from ..lights import distrib
from . import bvh as bvhmod
from . import cluster as clmod
from . import instances as instmod
from . import quadrics as quadmod
from . import triangle as trimod
from .types import QUAD_HYPERBOLOID, Hit, QuadricSoA, TriangleSoA


@dataclass
class Scene:
    tri: TriangleSoA
    quad: QuadricSoA
    clusters: Optional[clmod.ClusterSet]
    materials: Any               # shade.materials.MaterialTable
    lights: Any                  # lights.lights.LightTable
    textures: Any                # shade.textures.TextureTable or None
    light_distrib: Any           # lights.distrib.SpatialLightDistribution or None
    world_center: torch.Tensor   # (3,)
    world_radius: float          # a float32 value
    tile: int = clmod.TILE       # rays per tracer tile
    media: Any = None            # shade.media.MediumTable or None
    instances: Any = None        # tuple of instances.InstanceSet or None
    bvh: Any = None              # bvh.BVHArrays (traced when there are no clusters) or None

    @property
    def device(self):
        return self.tri.positions.device

    @functools.cached_property
    def light_power(self):
        """The power strategy's Distribution1D over the lights, built on
        first use and kept with the scene (a scene made by
        dataclasses.replace builds its own)."""
        return distrib.power_distribution(self.lights, self.world_radius)


def world_bounds(positions, quad_params=None, quad_o2w=None, quad_kind=None,
                 instances=None):
    """(center (3,) float32, radius as a float32 value) of the triangles'
    vertices, each quadric's conservative box and each instance's
    prototype vertices, as make_scene computes them in numpy: the box's xy
    extent is the largest radius-like parameter (the hyperboloid's grows
    with |z|), its z extent [z_min, z_max] widened by the radius, its 8
    corners taken to world space; an instance's vertices go through its
    slerped transform at 2 shutter times (5 if it rotates), and the radius
    grows by 5% when any instance moves."""
    pts = [np.asarray(positions, np.float32)] if len(positions) else []
    if quad_kind is not None and len(quad_kind):
        o2w = np.asarray(quad_o2w, np.float32)
        prm = np.asarray(quad_params, np.float32)
        r_xy = np.max(np.abs(prm[:, [0, 4, 5]]), axis=1)
        z2 = np.maximum(prm[:, 1] ** 2, prm[:, 2] ** 2)
        r_hyp = np.sqrt(np.maximum(1.0 + np.abs(prm[:, 5]) * z2, 0.0)
                        / np.maximum(np.abs(prm[:, 4]), 1e-12))
        r_xy = np.where(np.asarray(quad_kind) == QUAD_HYPERBOLOID, r_hyp, r_xy)
        ext = np.maximum(np.abs(prm[:, 0]), np.abs(prm[:, 4]))
        z_lo = np.minimum(prm[:, 1], -ext)
        z_hi = np.maximum(prm[:, 2], ext)
        for sx in (-1, 1):
            for sy in (-1, 1):
                for z in (z_lo, z_hi):
                    corner = np.stack([sx * r_xy, sy * r_xy, z], axis=-1)
                    pts.append(np.einsum("qij,qj->qi", o2w[:, :3, :3], corner)
                               + o2w[:, :3, 3])
    if instances:
        pts += _instance_points(instances)
    if not pts:
        return np.zeros(3, np.float32), 1.0
    allp = np.concatenate(pts, axis=0)
    lo, hi = allp.min(0), allp.max(0)
    center = (lo + hi) / 2.0
    radius = float(np.linalg.norm(hi - center)) + 1e-4
    if instances and any(s.animated for s in instances):
        # chord-sampling the slerp leaves a sliver between samples
        radius *= 1.05
    return np.asarray(center, np.float32), float(np.float32(radius))


def _instance_points(instances):
    """Each instance's prototype vertices through its transform at 2
    shutter times, 5 where it rotates (a slerp sweeps outside the end
    poses), from the sets' float32 columns in the JAX package's order of
    casts."""
    pts = []
    for iset in instances:
        pos = iset.proto.positions.cpu().numpy()
        cols = {k: getattr(iset, k).cpu().numpy() for k in ("lin", "q0", "q1", "t0", "t1")}
        for i in range(iset.count):
            lin, q0, q1, t0, t1 = (cols[k][i] for k in ("lin", "q0", "q1", "t0", "t1"))
            n_times = 2 if np.allclose(q0, q1) else 5
            for s in np.linspace(0.0, 1.0, n_times):
                d01 = float(np.clip(np.dot(q0, q1), -1.0, 1.0))
                qb = q1 if d01 >= 0 else -q1
                th = np.arccos(abs(d01))
                if th < 1e-6:
                    q = q0
                else:
                    q = (np.sin((1 - s) * th) * q0 + np.sin(s * th) * qb) / np.sin(th)
                q = q / np.linalg.norm(q)
                t = (1 - s) * t0 + s * t1
                pts.append(pos @ (instmod.quat_rotation_np(q) @ lin).T + t)
    return pts


def _window(n, active, device, t_min=None, t_max=None):
    """Per-lane (t_min, t_max): RAY_EPS and INF unless given (scalars or
    (N,)); lanes not `active` get t_max = -1."""
    f = dict(dtype=torch.float32, device=device)
    t_min = torch.full((n,), RAY_EPS, **f) if t_min is None else \
        torch.broadcast_to(torch.as_tensor(t_min, **f), (n,)).detach()
    t_max = torch.full((n,), INF, **f) if t_max is None else \
        torch.broadcast_to(torch.as_tensor(t_max, **f), (n,)).detach()
    if active is not None:
        t_max = torch.where(active, t_max, -1.0)
    return t_min, t_max


def _empty_hit(d):
    n = d.shape[0]
    z3 = torch.zeros_like(d)
    m1 = torch.full((n,), -1, dtype=torch.int64, device=d.device)
    return Hit(valid=torch.zeros((n,), dtype=torch.bool, device=d.device),
               t=torch.full((n,), INF, dtype=torch.float32, device=d.device), p=z3,
               ng=z3, ns=z3, uv=torch.zeros((n, 2), dtype=torch.float32, device=d.device),
               dpdu=z3, wo=-d, material_id=m1, light_id=m1,
               prim_kind=torch.zeros_like(m1), prim_id=m1,
               uv_scale=torch.ones((n,), dtype=torch.float32, device=d.device))


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


def _merge_quadrics(scene: Scene, hit: Hit, o, d, t_min, t_max) -> Hit:
    """The quadric pass: rays hitting a quadric nearer than the hit so
    far (or than t_max) take it, shading normal = geometric normal."""
    best_t = torch.where(hit.valid, hit.t, t_max)
    q_hit, q_t, q_idx, p, ng, uv, dpdu = quadmod.intersect_brute(scene.quad, o, d, t_min,
                                                                 best_t)
    take = q_hit & (q_t < best_t)
    q = scene.quad
    t3 = take[..., None]
    return Hit(valid=hit.valid | take, t=torch.where(take, q_t, hit.t),
               p=torch.where(t3, p, hit.p), ng=torch.where(t3, ng, hit.ng),
               ns=torch.where(t3, ng, hit.ns), uv=torch.where(t3, uv, hit.uv),
               dpdu=torch.where(t3, dpdu, hit.dpdu), wo=hit.wo,
               material_id=torch.where(take, q.material_id[q_idx], hit.material_id),
               light_id=torch.where(take, q.light_id[q_idx], hit.light_id),
               prim_kind=torch.where(take, 1, hit.prim_kind),
               prim_id=torch.where(take, q_idx, hit.prim_id),
               # a quadric's uv spans the whole surface: about 1/r per uv unit
               uv_scale=torch.where(take, 1.0 / torch.clamp(q.params[q_idx, 0], min=f32(1e-6)),
                                    hit.uv_scale))


def _merge_instance(hit: Hit, best_t, res) -> Hit:
    """An instance set's per-lane closest hits (instances.trace) taken
    where nearer than the hit so far (or than t_max)."""
    found, t, p, ng, ns, uv, dpdu, uvs, pid, mat, lid = res
    take = found & (t < best_t)
    t3 = take[..., None]
    return Hit(valid=hit.valid | take, t=torch.where(take, t, hit.t),
               p=torch.where(t3, p, hit.p), ng=torch.where(t3, ng, hit.ng),
               ns=torch.where(t3, ns, hit.ns), uv=torch.where(t3, uv, hit.uv),
               dpdu=torch.where(t3, dpdu, hit.dpdu), wo=hit.wo,
               material_id=torch.where(take, mat, hit.material_id),
               light_id=torch.where(take, lid, hit.light_id),
               prim_kind=torch.where(take, 2, hit.prim_kind),
               prim_id=torch.where(take, pid, hit.prim_id),
               uv_scale=torch.where(take, uvs, hit.uv_scale))


def _instance_pass(scene: Scene, hit, rays, occ, shadow, time):
    """Every instance set after the triangles and quadrics: the closest
    hits of `rays` (o, d, t_min, t_max) merged into `hit`, and the shadow
    rays (o, d, t_min, t_max) not yet occluded tested for any hit. Either
    part may be None. Returns (hit, occ)."""
    for iset in scene.instances:
        sub = sh = None
        if rays is not None:
            o, d, t_min, t_max = rays
            best_t = torch.where(hit.valid, hit.t, t_max)
            sub = (o, d, t_min, best_t)
        if shadow is not None:    # lanes already occluded need no more work
            sh = shadow[:3] + (torch.where(occ, -1.0, shadow[3]),)
        res, occ_i = instmod.trace(iset, sub, sh, time, scene.tile)
        if res is not None:
            hit = _merge_instance(hit, best_t, res)
        if occ_i is not None:
            occ = occ | occ_i
    return hit, occ


def _time(time, n, device):
    """The lanes' shutter times (N,) float32, or None (shutter open)."""
    if time is None:
        return None
    return torch.broadcast_to(torch.as_tensor(time, dtype=torch.float32, device=device),
                              (n,)).detach()


def _finish(scene: Scene, o, d, t_min, t_max, tri_result) -> Hit:
    """The hit record: wo = -d keeps d's gradient, the quadric pass gets
    the rays detached as the triangle tracers do."""
    if tri_result is None:
        hit = _empty_hit(d)
    else:
        hit = hit_from_triangles(scene, d, t_max, tri_result)
    if scene.quad.count:
        hit = _merge_quadrics(scene, hit, o.detach(), d.detach(), t_min, t_max)
    return hit


def _closest_triangles(scene: Scene, o, d, t_min, t_max):
    """The triangle pool's closest hits: clusters, else BVH, else brute force."""
    if scene.clusters is not None:
        return clmod.intersect(scene.clusters, o, d, t_min, t_max, scene.tile)
    if scene.bvh is not None:
        return bvhmod.traverse_closest(scene.bvh, scene.tri, o, d, t_min, t_max)
    return trimod.intersect_brute(scene.tri, o, d, t_min, t_max)


def _any_triangle(scene: Scene, o, d, t_min, t_max):
    """The triangle pool's any hit: clusters, else BVH, else brute force."""
    if scene.clusters is not None:
        return clmod.occluded(scene.clusters, o, d, t_min, t_max, scene.tile)
    if scene.bvh is not None:
        return bvhmod.traverse_any(scene.bvh, scene.tri, o, d, t_min, t_max)
    return trimod.occluded_brute(scene.tri, o, d, t_min, t_max)


@trace.spanned("tracer.intersect")
def intersect(scene: Scene, o, d, t_min=None, t_max=None, active=None, time=None) -> Hit:
    """Closest hit for rays o, d (N, 3) with t in (t_min, t_max) (defaults
    RAY_EPS and INF; scalars or (N,)); `active` marks live lanes (dead
    lanes get t_max < t_min and cost the tracer nothing); `time` the
    lanes' shutter times for animated instances (None: shutter open)."""
    t_min, t_max = _window(o.shape[0], active, o.device, t_min, t_max)
    res = None
    if scene.tri.count:
        # visibility is detached (pbrt_tpu/diff/inverse.py:1-12): no gradient
        # reaches the tracers, so the kernels and plain versions agree
        res = _closest_triangles(scene, o.detach(), d.detach(), t_min, t_max)
    hit = _finish(scene, o, d, t_min, t_max, res)
    if scene.instances:
        hit = _instance_pass(scene, hit, (o.detach(), d.detach(), t_min, t_max), None, None,
                             _time(time, o.shape[0], o.device))[0]
    return hit


@trace.spanned("tracer.intersect")
def occluded(scene: Scene, o, d, t_min=None, t_max=None, active=None, time=None):
    """Any-hit (shadow) query for rays o, d (N, 3) with t in (t_min, t_max)
    (defaults RAY_EPS and INF; scalars or (N,)). Dead lanes (`active`
    false) get t_max = -1. Returns occ (N,) bool."""
    # visibility is detached (pbrt_tpu/diff/inverse.py:1-12)
    o, d = o.detach(), d.detach()
    t_min, t_max = _window(o.shape[0], active, o.device, t_min, t_max)
    occ = _any_triangle(scene, o, d, t_min, t_max) if scene.tri.count else None
    occ = _or_quadrics(scene, occ, o, d, t_min, t_max)
    if scene.instances:
        occ = _instance_pass(scene, None, None, occ, (o, d, t_min, t_max),
                             _time(time, o.shape[0], o.device))[1]
    return occ


def _or_quadrics(scene: Scene, occ, o, d, t_min, t_max):
    """occ (or none yet) or'd with the quadrics' any hit."""
    if scene.quad.count:
        q = quadmod.occluded_brute(scene.quad, o, d, t_min, t_max)
        return q if occ is None else occ | q
    return torch.zeros_like(t_max, dtype=torch.bool) if occ is None else occ


@trace.spanned("tracer.intersect")
def intersect_occluded(scene: Scene, o, d, o_sh, d_sh, tmax_sh, active=None,
                       active_sh=None, time=None):
    """Fused closest hit (o, d) and shadow query (o_sh, d_sh) with t in
    (RAY_EPS, tmax_sh), at the lanes' shutter times `time` (N,) or None.
    Returns (Hit, occ)."""
    t_min, t_max = _window(o.shape[0], active, o.device)
    # visibility is detached (pbrt_tpu/diff/inverse.py:1-12); wo keeps d's gradient
    o_, d_ = o.detach(), d.detach()
    o_sh, d_sh, tmax_sh = o_sh.detach(), d_sh.detach(), tmax_sh.detach()
    tmin_sh = torch.full_like(tmax_sh, RAY_EPS)
    if active_sh is not None:
        tmax_sh = torch.where(active_sh, tmax_sh, -1.0)
    res = occ = None
    if scene.tri.count:
        if scene.clusters is not None:
            res, occ = clmod.intersect_occluded(scene.clusters, o_, d_, t_min, t_max,
                                                o_sh, d_sh, tmin_sh, tmax_sh, scene.tile)
        else:
            res = _closest_triangles(scene, o_, d_, t_min, t_max)
            occ = _any_triangle(scene, o_sh, d_sh, tmin_sh, tmax_sh)
    hit = _finish(scene, o, d, t_min, t_max, res)
    occ = _or_quadrics(scene, occ, o_sh, d_sh, tmin_sh, tmax_sh)
    if scene.instances:
        hit, occ = _instance_pass(scene, hit, (o_, d_, t_min, t_max), occ,
                                  (o_sh, d_sh, tmin_sh, tmax_sh),
                                  _time(time, o.shape[0], o.device))
    return hit, occ
