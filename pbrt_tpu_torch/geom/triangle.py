"""Ray–triangle intersection and hit shading (counterpart of
pbrt_tpu/geom/triangle.py). The brute-force tracers are the tests'
independent reference for the cluster tracer."""
from __future__ import annotations

import torch

from ..core import vecmath as vm
from ..core.types import INF, f32

# ray×triangle pairs per chunk of the brute-force tracers
_BRUTE_PAIR_BUDGET = 16 * 1024 * 1024


def moller_trumbore(o, d, p0, p1, p2, t_min, t_max):
    """Returns (hit, t, b1, b2); b1/b2 are the barycentrics of p1/p2."""
    e1 = p1 - p0
    e2 = p2 - p0
    pv = vm.cross(d, e2)
    det = vm.dot(e1, pv)
    big = det.abs() > f32(1e-12)
    inv_det = torch.where(big, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    tv = o - p0
    b1 = vm.dot(tv, pv) * inv_det
    qv = vm.cross(tv, e1)
    b2 = vm.dot(d, qv) * inv_det
    t = vm.dot(e2, qv) * inv_det
    hit = big & (b1 >= 0.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0) & (t > t_min) & (t < t_max)
    return hit, torch.where(hit, t, INF), b1, b2


def _chunks(tri, n_rays):
    p0, p1, p2 = tri.corners()
    chunk = max(_BRUTE_PAIR_BUDGET // max(n_rays, 1), 256)
    for s in range(0, tri.count, chunk):
        yield s, p0[s:s + chunk], p1[s:s + chunk], p2[s:s + chunk]


def intersect_brute(tri, o, d, t_min, t_max):
    """All-pairs closest hit over rays (N, 3). Returns (hit, t, tri_idx,
    b1, b2)."""
    n = o.shape[0]
    any_hit = torch.zeros(n, dtype=torch.bool, device=o.device)
    best_t = torch.broadcast_to(t_max, (n,)).to(torch.float32).clone()
    best_i = torch.zeros(n, dtype=torch.int64, device=o.device)
    best_b1 = torch.zeros(n, dtype=torch.float32, device=o.device)
    best_b2 = torch.zeros_like(best_b1)
    for s, p0, p1, p2 in _chunks(tri, n):
        hit, t, b1, b2 = moller_trumbore(o[:, None], d[:, None], p0, p1, p2,
                                         t_min[:, None], best_t[:, None])
        j = torch.argmin(t, -1, keepdim=True)
        take = lambda a: torch.gather(a, -1, j)[:, 0]  # noqa: E731
        tj = take(t)
        upd = take(hit) & (tj < best_t)
        any_hit = any_hit | upd
        best_t = torch.where(upd, tj, best_t)
        best_i = torch.where(upd, j[:, 0] + s, best_i)
        best_b1 = torch.where(upd, take(b1), best_b1)
        best_b2 = torch.where(upd, take(b2), best_b2)
    return any_hit, torch.where(any_hit, best_t, INF), best_i, best_b1, best_b2


def occluded_brute(tri, o, d, t_min, t_max):
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    for _, p0, p1, p2 in _chunks(tri, n):
        hit, _, _, _ = moller_trumbore(o[:, None], d[:, None], p0, p1, p2,
                                       t_min[:, None], t_max[:, None])
        occ = occ | hit.any(-1)
    return occ


def _uv_scale(uv_det, e1, e2):
    """uv units per world unit of the triangle's parametrization."""
    world2 = vm.length(vm.cross(e1, e2))
    return torch.sqrt(uv_det.abs() / torch.clamp(world2, min=f32(1e-20)))


def shading_from_rec(tri, tri_idx, b1, b2):
    """Hit shading data through one packed-record gather. Returns
    (p, ng, ns, uv, dpdu, uv_scale, material_id, light_id)."""
    r = tri.shade_rec[tri_idx]
    p0, p1, p2 = r[..., 0:3], r[..., 3:6], r[..., 6:9]
    uv0, uv1, uv2 = r[..., 9:11], r[..., 11:13], r[..., 13:15]
    n0, n1, n2 = r[..., 15:18], r[..., 18:21], r[..., 21:24]
    b0 = 1.0 - b1 - b2
    p = b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2
    ng = vm.normalize(vm.cross(p1 - p0, p2 - p0))
    uv = b0[..., None] * uv0 + b1[..., None] * uv1 + b2[..., None] * uv2
    duv02 = uv0 - uv2
    duv12 = uv1 - uv2
    dp02 = p0 - p2
    dp12 = p1 - p2
    det = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
    degenerate = det.abs() <= f32(1e-10)
    inv_det = torch.where(~degenerate, 1.0 / torch.where(det != 0.0, det, 1.0), 0.0)
    dpdu = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv_det[..., None]
    fallback, _ = vm.coordinate_system(ng)
    dpdu = torch.where(degenerate[..., None], fallback, vm.normalize(dpdu))
    ns_interp = b0[..., None] * n0 + b1[..., None] * n1 + b2[..., None] * n2
    has_ns = (r[..., 24] > 0.5) & (vm.length_squared(ns_interp) > f32(1e-12))
    ns = torch.where(has_ns[..., None], vm.normalize(ns_interp), ng)
    ng = vm.face_forward(ng, ns)
    dpdu = vm.normalize(dpdu - vm.dot(dpdu, ns)[..., None] * ns)
    uv_scale = _uv_scale(det, p1 - p0, p2 - p0)
    return (p, ng, ns, uv, dpdu, uv_scale, r[..., 25].to(torch.int64),
            r[..., 26].to(torch.int64))
