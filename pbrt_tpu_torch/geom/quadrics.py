"""Ray–quadric intersection and sphere sampling (counterpart of
pbrt_tpu/geom/quadrics.py), plain PyTorch as the JAX package has it in
plain jnp.

One branch-free test covers the six kinds: the kinds differ only in
their implicit coefficients, so each lane takes its kind's coefficients
by a where-select, then z / φ clipping with the t0 → t1 retry and the
shading frame. Only the kinds in the pool's `kinds_present` are
evaluated: a lane of a present kind takes the very values the full
select would give it, and a pool of spheres does not pay for the other
five kinds' arithmetic.
"""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.types import INF, PI, f32, quadratic, safe_sqrt
from .types import (QUAD_CONE, QUAD_CYLINDER, QUAD_DISK, QUAD_HYPERBOLOID,
                    QUAD_PARABOLOID, QUAD_SPHERE)

ALL_KINDS = (QUAD_SPHERE, QUAD_DISK, QUAD_CYLINDER, QUAD_CONE, QUAD_PARABOLOID,
             QUAD_HYPERBOLOID)


def _point(m, p):
    return (m[..., :3, :3] * p[..., None, :]).sum(-1) + m[..., :3, 3]


def _vector(m, v):
    return (m[..., :3, :3] * v[..., None, :]).sum(-1)


def _normal(w2o, n):
    """The inverse transpose of object→world applied to n."""
    return (w2o[..., :3, :3] * n[..., :, None]).sum(-2)


def _select(kind, values, order):
    """values[k] for each lane's kind, as the JAX package's nested
    where-select in `order` (its last entry the default)."""
    present = [k for k in order if k in values]
    if not present:
        return None
    out = values[present[-1]]
    for k in reversed(present[:-1]):
        out = torch.where(kind == k, values[k], out)
    return out


def _stack(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), -1)


def intersect_one(kind, w2o, o2w, params, o, d, t_min, t_max, kinds=ALL_KINDS):
    """Rays (broadcast batch) against one quadric each: kind, transforms
    and params broadcast with the rays. Returns (hit, t, p_world,
    ng_world, uv, dpdu_world)."""
    ro, rd = _point(w2o, o), _vector(w2o, d)
    r = params[..., 0]
    z_min, z_max, phi_max = params[..., 1], params[..., 2], params[..., 3]
    e0, e1 = params[..., 4], params[..., 5]
    ox, oy, oz = ro.unbind(-1)
    dx, dy, dz = rd.unbind(-1)

    # quadratic coefficients per kind
    a, b, c = {}, {}, {}
    if QUAD_SPHERE in kinds:
        a[QUAD_SPHERE] = dx * dx + dy * dy + dz * dz
        b[QUAD_SPHERE] = 2.0 * (ox * dx + oy * dy + oz * dz)
        c[QUAD_SPHERE] = ox * ox + oy * oy + oz * oz - r * r
    if QUAD_CYLINDER in kinds:
        a[QUAD_CYLINDER] = dx * dx + dy * dy
        b[QUAD_CYLINDER] = 2.0 * (ox * dx + oy * dy)
        c[QUAD_CYLINDER] = ox * ox + oy * oy - r * r
    if QUAD_CONE in kinds:
        # k = (r / h)^2 with the apex at z = h; e0 = height
        h = torch.where(e0 != 0.0, e0, z_max)
        kcone = (r / torch.clamp(h, min=f32(1e-8))) ** 2
        a[QUAD_CONE] = dx * dx + dy * dy - kcone * dz * dz
        b[QUAD_CONE] = 2.0 * (ox * dx + oy * dy - kcone * dz * (oz - h))
        c[QUAD_CONE] = ox * ox + oy * oy - kcone * (oz - h) * (oz - h)
    if QUAD_PARABOLOID in kinds:
        # k (x² + y²) − z = 0 with k = z_max / r²
        kpar = z_max / torch.clamp(r * r, min=f32(1e-12))
        a[QUAD_PARABOLOID] = kpar * (dx * dx + dy * dy)
        b[QUAD_PARABOLOID] = 2.0 * kpar * (ox * dx + oy * dy) - dz
        c[QUAD_PARABOLOID] = kpar * (ox * ox + oy * oy) - oz
    if QUAD_HYPERBOLOID in kinds:
        # a_h (x² + y²) − c_h z² = 1; e0 = a_h, e1 = c_h
        a[QUAD_HYPERBOLOID] = e0 * (dx * dx + dy * dy) - e1 * dz * dz
        b[QUAD_HYPERBOLOID] = 2.0 * (e0 * (ox * dx + oy * dy) - e1 * oz * dz)
        c[QUAD_HYPERBOLOID] = e0 * (ox * ox + oy * oy) - e1 * oz * oz - 1.0
    order = (QUAD_SPHERE, QUAD_CYLINDER, QUAD_CONE, QUAD_PARABOLOID, QUAD_HYPERBOLOID)
    if a:
        has, t0, t1 = quadratic(_select(kind, a, order), _select(kind, b, order),
                                _select(kind, c, order))
    else:
        has = torch.zeros_like(dz, dtype=torch.bool)
        t0 = t1 = torch.full_like(dz, INF)
    is_disk = kind == QUAD_DISK
    if QUAD_DISK in kinds:
        # planar hit at z = e0 (the disk's height), radial clip [e1, r]
        t_disk = torch.where(dz.abs() > f32(1e-9),
                             (e0 - oz) / torch.where(dz != 0.0, dz, 1.0), INF)
        has = torch.where(is_disk, dz.abs() > f32(1e-9), has)
        t0 = torch.where(is_disk, t_disk, t0)
        t1 = torch.where(is_disk, INF, t1)

    def eval_at(t):
        p = ro + t[..., None] * rd
        if QUAD_SPHERE in kinds:
            # re-project a sphere hit onto the surface
            pr = p * (r / torch.clamp(vm.length(p), min=f32(1e-12)))[..., None]
            p = torch.where((kind == QUAD_SPHERE)[..., None], pr, p)
        phi = vm.spherical_phi(p)
        phiok = phi <= phi_max
        ok = (p[..., 2] >= z_min) & (p[..., 2] <= z_max) & phiok
        if QUAD_DISK in kinds:
            rad2 = p[..., 0] ** 2 + p[..., 1] ** 2
            ok = torch.where(is_disk, (rad2 <= r * r) & (rad2 >= e1 * e1) & phiok, ok)
        return p, phi, ok

    p0c, phi0, ok0 = eval_at(t0)
    p1c, phi1, ok1 = eval_at(t1)
    in0 = has & (t0 > t_min) & (t0 < t_max) & ok0
    in1 = has & (t1 > t_min) & (t1 < t_max) & ok1
    hit = in0 | in1
    t = torch.where(in0, t0, torch.where(in1, t1, INF))
    p = torch.where(in0[..., None], p0c, p1c)
    phi = torch.where(in0, phi0, phi1)

    # object-space normal from the implicit gradient
    px, py, pz = p.unbind(-1)
    zero = torch.zeros_like(pz)
    n = {}
    if QUAD_SPHERE in kinds:
        n[QUAD_SPHERE] = p
    if QUAD_DISK in kinds:
        n[QUAD_DISK] = _stack(zero, zero, zero + 1.0)
    if QUAD_CYLINDER in kinds:
        n[QUAD_CYLINDER] = _stack(px, py, zero)
    if QUAD_CONE in kinds:
        n[QUAD_CONE] = _stack(px, py, -kcone * (pz - h))
    if QUAD_PARABOLOID in kinds:
        n[QUAD_PARABOLOID] = _stack(2.0 * kpar * px, 2.0 * kpar * py, zero - 1.0)
    if QUAD_HYPERBOLOID in kinds:
        n[QUAD_HYPERBOLOID] = _stack(e0 * px, e0 * py, -e1 * pz)
    ng_obj = vm.normalize(_select(kind[..., None], n, (QUAD_SPHERE, QUAD_DISK, QUAD_CYLINDER,
                                                       QUAD_CONE, QUAD_PARABOLOID,
                                                       QUAD_HYPERBOLOID)))

    # uv: u along φ, v along θ (sphere), radius (disk) or z (the rest)
    u = phi / torch.clamp(phi_max, min=f32(1e-9))
    v = {}
    if QUAD_SPHERE in kinds:
        rs = torch.clamp(r, min=f32(1e-12))
        theta = torch.arccos(torch.clamp(pz / rs, -1.0, 1.0))
        tmin_s = torch.arccos(torch.clamp(z_max / rs, -1.0, 1.0))
        tmax_s = torch.arccos(torch.clamp(z_min / rs, -1.0, 1.0))
        v[QUAD_SPHERE] = (theta - tmin_s) / torch.clamp(tmax_s - tmin_s, min=f32(1e-9))
    if QUAD_DISK in kinds:
        rad = safe_sqrt(px * px + py * py)
        v[QUAD_DISK] = 1.0 - (rad - e1) / torch.clamp(r - e1, min=f32(1e-9))
    if set(kinds) - {QUAD_SPHERE, QUAD_DISK}:
        v[QUAD_CYLINDER] = (pz - z_min) / torch.clamp(z_max - z_min, min=f32(1e-9))
    uv = torch.stack([u, _select(kind, v, (QUAD_SPHERE, QUAD_DISK, QUAD_CYLINDER))], -1)

    # dpdu = ∂p/∂φ (every kind is a surface of revolution)
    dpdu_obj = _stack(-phi_max * py, phi_max * px, zero)
    if QUAD_DISK in kinds:
        dpdu_obj = torch.where(is_disk[..., None], _stack(-py, px, zero), dpdu_obj)
    small = vm.length_squared(dpdu_obj) < f32(1e-14)
    fb, _ = vm.coordinate_system(ng_obj)
    dpdu_obj = torch.where(small[..., None], fb, vm.normalize(dpdu_obj))

    p_w = _point(o2w, p)
    ng_w = vm.normalize(_normal(w2o, ng_obj))
    dpdu_w = vm.normalize(_vector(o2w, dpdu_obj))
    return hit, torch.where(hit, t, INF), p_w, ng_w, uv, dpdu_w


def _all_pairs(quad, o, d, t_min, t_max):
    return intersect_one(quad.kind, quad.world_to_obj, quad.obj_to_world, quad.params,
                         o[..., None, :], d[..., None, :], t_min[..., None],
                         t_max[..., None], quad.kinds_present)


def intersect_brute(quad, o, d, t_min, t_max):
    """Every ray against every quadric; the nearest hit of each ray.
    Returns (hit, t, quad_idx, p, ng, uv, dpdu)."""
    hit, t, p, ng, uv, dpdu = _all_pairs(quad, o, d, t_min, t_max)
    best = torch.argmin(t, -1)
    tk = lambda a: torch.gather(a, -1, best[..., None])[..., 0]  # noqa: E731

    def tk3(a):
        idx = best[..., None, None].expand(*best.shape, 1, a.shape[-1])
        return torch.gather(a, -2, idx)[..., 0, :]
    return tk(hit), tk(t), best, tk3(p), tk3(ng), tk3(uv), tk3(dpdu)


def occluded_brute(quad, o, d, t_min, t_max):
    return _all_pairs(quad, o, d, t_min, t_max)[0].any(-1)


def sphere_sample(quad, quad_idx, p_ref, u2):
    """A point on sphere quad_idx seen from p_ref: the visible cone from
    outside, the whole sphere by area from inside. Returns (p_light, ng,
    pdf per solid angle)."""
    center = quad.obj_to_world[quad_idx][..., :3, 3]
    radius = quad.params[quad_idx, ..., 0]
    dc = center - p_ref
    dist2 = vm.length_squared(dc)
    dist = torch.sqrt(torch.clamp(dist2, min=f32(1e-12)))
    inside = dist2 <= radius * radius * f32(1.0001)

    # outside: sample the cone the sphere subtends
    sin2_max = torch.clamp(radius * radius / dist2, 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2_max)
    cos_t = (1.0 - u2[..., 0]) + u2[..., 0] * cos_max
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * PI * u2[..., 1]
    ds = dist * cos_t - safe_sqrt(torch.clamp(radius * radius - dist2 * sin_t * sin_t,
                                              min=0.0))
    cos_alpha = (dist2 + radius * radius - ds * ds) / torch.clamp(2.0 * dist * radius,
                                                                  min=f32(1e-12))
    sin_alpha = safe_sqrt(1.0 - cos_alpha * cos_alpha)
    wz = vm.normalize(dc)
    wx, wy = vm.coordinate_system(wz)
    n_obj = -(sin_alpha[..., None] * (torch.cos(phi)[..., None] * wx
                                      + torch.sin(phi)[..., None] * wy)
              + cos_alpha[..., None] * wz)
    p_cone = center + radius[..., None] * (-n_obj)
    pdf_cone = 1.0 / (2.0 * PI * torch.clamp(1.0 - cos_max, min=f32(1e-9)))

    # inside: uniform over the sphere, area pdf → solid-angle pdf
    z = 1.0 - 2.0 * u2[..., 0]
    rr = safe_sqrt(1.0 - z * z)
    n_in = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], -1)
    p_in = center + radius[..., None] * n_in
    wi_in = p_in - p_ref
    d2_in = torch.clamp(vm.length_squared(wi_in), min=f32(1e-12))
    cos_l = vm.absdot(n_in, -vm.normalize(wi_in))
    pdf_in = d2_in / torch.clamp(cos_l * (4.0 * PI * radius * radius), min=f32(1e-12))

    return (torch.where(inside[..., None], p_in, p_cone),
            torch.where(inside[..., None], n_in, -n_obj),
            torch.where(inside, pdf_in, pdf_cone))


def sphere_pdf(quad, quad_idx, p_ref, wi):
    """Solid-angle pdf of sphere_sample for direction wi."""
    center = quad.obj_to_world[quad_idx][..., :3, 3]
    radius = quad.params[quad_idx, ..., 0]
    dist2 = vm.length_squared(center - p_ref)
    sin2_max = torch.clamp(radius * radius / torch.clamp(dist2, min=f32(1e-12)), 0.0, 1.0)
    cos_max = safe_sqrt(1.0 - sin2_max)
    return torch.where(dist2 > radius * radius,
                       1.0 / (2.0 * PI * torch.clamp(1.0 - cos_max, min=f32(1e-9))), 0.0)
