"""CPU oracle: an independent numpy implementation of the direct-lighting
renderer (the port's own copy of pbrt_tpu/oracle/cpu_reference.py; the
cited algorithms: estimate_direct integrator.rs:136-266, Möller–Trumbore,
sphere.rs's quadratic).

It reads the port's Scene and perspective camera (their tensors moved to
numpy) and keeps its own numpy mirror of the counter-based RNG, so its
sample streams equal the renderer's bit for bit under the 'random'
sampler: images must agree to float tolerance, not just statistically.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import samplers as smp
from ..lights.lights import LIGHT_AREA_TRI, LIGHT_POINT

_PCG_MULT = np.uint32(747796405)
_PCG_INC = np.uint32(2891336453)


def np_pcg_hash(x):
    """uint32 → uint32 mix (PCG output permutation RXS-M-XS)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        state = x * _PCG_MULT + _PCG_INC
        word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) \
            * np.uint32(277803737)
    return (word >> np.uint32(22)) ^ word


def np_hash_combine(*keys):
    """Fold uint32 keys into one (boost-style combine)."""
    h = np.asarray(keys[0], np.uint32)
    with np.errstate(over="ignore"):
        for k in keys[1:]:
            k = np.asarray(k, np.uint32)
            h = np_pcg_hash(h ^ (k + np.uint32(0x9E3779B9) + (h << np.uint32(6))
                                 + (h >> np.uint32(2))))
    return h


def np_uniform_float(*keys):
    """U[0, 1) float32 from uint32 keys."""
    bits = np_pcg_hash(np_hash_combine(*keys))
    return np.minimum((bits >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / (1 << 24)),
                      np.float32(1.0 - np.finfo(np.float32).eps / 2))


F = np.float32


def _u1(seed, pix, samp, dim):
    return np_uniform_float(np.uint32(seed), pix.astype(np.uint32),
                            np.uint32(samp), np.uint32(dim))


def _u2(seed, pix, samp, dim):
    return np.stack([_u1(seed, pix, samp, dim), _u1(seed, pix, samp, dim + 1)], -1)


def _norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-20)


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _np(x):
    """A tensor (or scalar) as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ------------------------------------------------------------ intersect

def intersect(scene, o, d, t_min=1e-4, t_max=np.inf):
    n = o.shape[0]
    best_t = np.full(n, t_max, F)
    hit = dict(valid=np.zeros(n, bool), t=best_t.copy(),
               p=np.zeros((n, 3), F), ng=np.zeros((n, 3), F), ns=np.zeros((n, 3), F),
               mat=np.full(n, -1, np.int32), light=np.full(n, -1, np.int32),
               uv=np.zeros((n, 2), F), dpdu=np.zeros((n, 3), F))

    tri = scene.tri
    if tri is not None and _np(tri.indices).shape[0]:
        verts = _np(tri.positions)
        idx = _np(tri.indices)
        p0, p1, p2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
        e1 = (p1 - p0)[None]
        e2 = (p2 - p0)[None]
        pv = np.cross(d[:, None, :], e2)
        det = np.sum(e1 * pv, -1)
        inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0).astype(F)
        tv = o[:, None, :] - p0[None]
        b1 = np.sum(tv * pv, -1) * inv
        qv = np.cross(tv, e1)
        b2 = np.sum(d[:, None, :] * qv, -1) * inv
        t = np.sum(e2 * qv, -1) * inv
        ok = (np.abs(det) > 1e-12) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) \
            & (t > t_min) & (t < best_t[:, None])
        t = np.where(ok, t, np.inf).astype(F)
        j = np.argmin(t, axis=1)
        rows = np.arange(n)
        tj = t[rows, j]
        take = np.isfinite(tj) & (tj < best_t)
        best_t = np.where(take, tj, best_t)
        ng = _norm(np.cross(p1 - p0, p2 - p0))[j]
        hit["valid"] |= take
        hit["t"] = best_t
        for k, v in [("p", o + tj[:, None] * d), ("ng", ng), ("ns", ng)]:
            hit[k] = np.where(take[:, None], v.astype(F), hit[k])
        hit["mat"] = np.where(take, _np(tri.material_id)[j], hit["mat"])
        hit["light"] = np.where(take, _np(tri.light_id)[j], hit["light"])
        # dpdu from the UV parameterisation (mirrors geom.triangle.
        # shading_geometry) with coordinate-system fallback
        uvs = _np(tri.uvs)
        ji = idx[j]
        uv0, uv1, uv2 = uvs[ji[:, 0]], uvs[ji[:, 1]], uvs[ji[:, 2]]
        q0, q1, q2 = verts[ji[:, 0]], verts[ji[:, 1]], verts[ji[:, 2]]
        duv02 = uv0 - uv2
        duv12 = uv1 - uv2
        dp02 = q0 - q2
        dp12 = q1 - q2
        detuv = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        invuv = np.where(np.abs(detuv) > 1e-10, 1.0 / np.where(detuv == 0, 1, detuv), 0.0).astype(F)
        dpdu = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * invuv[:, None]
        degen = np.abs(detuv) <= 1e-10
        dpdu = np.where(degen[:, None], _coord_sys(hit["ns"]), _norm(dpdu)).astype(F)
        nsj = hit["ns"]
        dpdu = _norm(dpdu - _dot(dpdu, nsj)[:, None] * nsj).astype(F)
        hit["dpdu"] = np.where(take[:, None], dpdu, hit["dpdu"])

    quad = scene.quad
    if quad is not None and _np(quad.kind).shape[0]:
        centers = _np(quad.obj_to_world)[:, :3, 3]
        radius = _np(quad.params)[:, 0]
        oc = o[:, None, :] - centers[None]
        a = np.sum(d * d, -1)[:, None]
        b = 2 * np.sum(oc * d[:, None, :], -1)
        c = np.sum(oc * oc, -1) - radius[None] ** 2
        disc = b * b - 4 * a * c
        has = disc >= 0
        sq = np.sqrt(np.maximum(disc, 0))
        q = np.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        t0 = np.where(a != 0, q / np.where(a == 0, 1, a), np.inf)
        t1 = np.where(q != 0, c / np.where(q == 0, 1, q), np.inf)
        lo = np.minimum(t0, t1)
        hi_ = np.maximum(t0, t1)
        tq = np.where(has & (lo > t_min) & (lo < best_t[:, None]), lo,
                      np.where(has & (hi_ > t_min) & (hi_ < best_t[:, None]), hi_, np.inf)).astype(F)
        j = np.argmin(tq, axis=1)
        rows = np.arange(n)
        tj = tq[rows, j]
        take = np.isfinite(tj) & (tj < best_t)
        best_t = np.where(take, tj, best_t)
        pq = o + tj[:, None] * d
        # re-project like the device kernel
        rel = pq - centers[j]
        rel = rel * (radius[j] / np.maximum(np.linalg.norm(rel, axis=-1), 1e-12))[:, None]
        pq = centers[j] + rel
        ngq = _norm(rel)
        hit["valid"] |= take
        hit["t"] = best_t
        hit["p"] = np.where(take[:, None], pq.astype(F), hit["p"])
        hit["ng"] = np.where(take[:, None], ngq.astype(F), hit["ng"])
        hit["ns"] = np.where(take[:, None], ngq.astype(F), hit["ns"])
        hit["mat"] = np.where(take, _np(quad.material_id)[j], hit["mat"])
        hit["light"] = np.where(take, _np(quad.light_id)[j], hit["light"])
        # sphere dpdu = φ-tangent (mirrors geom.quadrics.intersect_one)
        phi_max = _np(quad.params)[j, 3]
        dpdu_q = np.stack([-phi_max * rel[:, 1], phi_max * rel[:, 0],
                           np.zeros(n, F)], -1)
        small = np.sum(dpdu_q * dpdu_q, -1) < 1e-14
        dpdu_q = np.where(small[:, None], _coord_sys(hit["ns"]), _norm(dpdu_q)).astype(F)
        hit["dpdu"] = np.where(take[:, None], dpdu_q, hit["dpdu"])
    return hit


def _coord_sys(n):
    s = np.where(n[..., 2] >= 0, 1.0, -1.0).astype(F)
    a = (-1.0 / (s + n[..., 2])).astype(F)
    b = (n[..., 0] * n[..., 1] * a).astype(F)
    return np.stack([1.0 + s * n[..., 0] ** 2 * a, s * b, -s * n[..., 0]], -1).astype(F)


def occluded(scene, o, d, t_max):
    t_min = 1e-4
    n = o.shape[0]
    occ = np.zeros(n, bool)
    tri = scene.tri
    if tri is not None and _np(tri.indices).shape[0]:
        verts = _np(tri.positions)
        idx = _np(tri.indices)
        p0, p1, p2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
        pv = np.cross(d[:, None, :], (p2 - p0)[None])
        det = np.sum((p1 - p0)[None] * pv, -1)
        inv = np.where(np.abs(det) > 1e-12, 1.0 / np.where(det == 0, 1, det), 0.0).astype(F)
        tv = o[:, None, :] - p0[None]
        b1 = np.sum(tv * pv, -1) * inv
        qv = np.cross(tv, (p1 - p0)[None])
        b2 = np.sum(d[:, None, :] * qv, -1) * inv
        t = np.sum((p2 - p0)[None] * qv, -1) * inv
        ok = (np.abs(det) > 1e-12) & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) \
            & (t > t_min) & (t < t_max[:, None])
        occ |= ok.any(1)
    quad = scene.quad
    if quad is not None and _np(quad.kind).shape[0]:
        centers = _np(quad.obj_to_world)[:, :3, 3]
        radius = _np(quad.params)[:, 0]
        oc = o[:, None, :] - centers[None]
        a = np.sum(d * d, -1)[:, None]
        b = 2 * np.sum(oc * d[:, None, :], -1)
        c = np.sum(oc * oc, -1) - radius[None] ** 2
        disc = b * b - 4 * a * c
        sq = np.sqrt(np.maximum(disc, 0))
        q = np.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        t0 = np.where(a != 0, q / np.where(a == 0, 1, a), np.inf)
        t1 = np.where(q != 0, c / np.where(q == 0, 1, q), np.inf)
        ok = (disc >= 0) & (((np.minimum(t0, t1) > t_min) & (np.minimum(t0, t1) < t_max[:, None]))
                            | ((np.maximum(t0, t1) > t_min) & (np.maximum(t0, t1) < t_max[:, None])))
        occ |= ok.any(1)
    return occ


# --------------------------------------------------------------- shading

def _offset_origin(p, ng, d):
    eps = 1e-4 * np.maximum(1.0, np.max(np.abs(p), axis=-1))
    off = np.where(_dot(d, ng) < 0, -eps, eps).astype(F)
    return p + off[:, None] * ng


def _concentric_disk(u):
    ox, oy = 2 * u[..., 0] - 1, 2 * u[..., 1] - 1
    zero = (ox == 0) & (oy == 0)
    use_x = np.abs(ox) > np.abs(oy)
    r = np.where(use_x, ox, oy)
    theta = np.where(use_x, (np.pi / 4) * np.where(ox != 0, oy / np.where(ox == 0, 1, ox), 0),
                     np.pi / 2 - (np.pi / 4) * np.where(oy != 0, ox / np.where(oy == 0, 1, oy), 0))
    p = np.stack([r * np.cos(theta), r * np.sin(theta)], -1)
    return np.where(zero[..., None], 0.0, p).astype(F)


def _cos_hemisphere(u):
    dsk = _concentric_disk(u)
    z = np.sqrt(np.maximum(0, 1 - dsk[..., 0] ** 2 - dsk[..., 1] ** 2)).astype(F)
    return np.concatenate([dsk, z[..., None]], -1)


def _frame(ns, dpdu):
    t = dpdu
    b = _norm(np.cross(ns, t))
    t = np.cross(b, ns)
    return t, b


def _power_heuristic(fp, gp):
    f2 = fp * fp
    return f2 / np.maximum(f2 + gp * gp, 1e-20)


def _sample_area_light(lights, scene, li_idx, p_ref, u2):
    """Mirror of lights.sample_li for LIGHT_AREA_TRI."""
    cdf = _np(lights.em_tri_cdf)[li_idx]
    u0 = u2[..., 0]
    slot = np.clip(np.sum(cdf <= u0[:, None], axis=-1) - 1, 0, cdf.shape[-1] - 2)
    rows = np.arange(len(u0))
    c0 = cdf[rows, slot]
    c1 = cdf[rows, slot + 1]
    u0r = (u0 - c0) / np.maximum(c1 - c0, 1e-9)
    tid = np.maximum(_np(lights.em_tri_idx)[li_idx, slot], 0)
    verts = _np(scene.tri.positions)
    idx = _np(scene.tri.indices)[tid]
    p0, p1, p2 = verts[idx[:, 0]], verts[idx[:, 1]], verts[idx[:, 2]]
    su0 = np.sqrt(np.maximum(u0r, 0)).astype(F)
    b0 = 1 - su0
    b1 = (u2[..., 1] * su0).astype(F)
    pl = b0[:, None] * p0 + b1[:, None] * p1 + (1 - b0 - b1)[:, None] * p2
    nl = np.cross(p1 - p0, p2 - p0)
    ngl = _norm(nl)
    return pl.astype(F), ngl.astype(F)


def _sample_li(lights, scene, lt, p_ref, u2, world_radius):
    kind = _np(lights.kind)[lt]
    emit = _np(lights.emit)[lt]
    n = len(lt)
    wi = np.zeros((n, 3), F)
    li = np.zeros((n, 3), F)
    pdf = np.zeros(n, F)
    dist = np.zeros(n, F)
    delta = np.zeros(n, bool)

    m = kind == LIGHT_POINT
    if m.any():
        to_l = _np(lights.p)[lt] - p_ref
        d2 = np.maximum(np.sum(to_l * to_l, -1), 1e-12)
        dd = np.sqrt(d2)
        wi = np.where(m[:, None], to_l / dd[:, None], wi).astype(F)
        li = np.where(m[:, None], emit / d2[:, None], li).astype(F)
        pdf = np.where(m, 1.0, pdf).astype(F)
        dist = np.where(m, dd, dist).astype(F)
        delta |= m

    m = kind == LIGHT_AREA_TRI
    if m.any():
        pl, ngl = _sample_area_light(lights, scene, lt, p_ref, u2)
        to_l = pl - p_ref
        d2 = np.maximum(np.sum(to_l * to_l, -1), 1e-12)
        dd = np.sqrt(d2)
        wik = (to_l / dd[:, None]).astype(F)
        cos_l = _dot(ngl, -wik)
        ts = _np(lights.two_sided)[lt]
        ok = ts | (cos_l > 0)
        lik = np.where(ok[:, None], emit, 0.0).astype(F)
        pdfk = (d2 / (np.maximum(np.abs(cos_l), 1e-8)
                      * np.maximum(_np(lights.total_area)[lt], 1e-12))).astype(F)
        pdfk = np.where(np.abs(cos_l) < 1e-7, 0.0, pdfk).astype(F)
        wi = np.where(m[:, None], wik, wi)
        li = np.where(m[:, None], lik, li)
        pdf = np.where(m, pdfk, pdf)
        dist = np.where(m, dd, dist).astype(F)
    return dict(wi=wi, li=li, pdf=pdf, dist=dist, is_delta=delta)


def _lambert_f(kd, wo_l, wi_l):
    same = wo_l[..., 2] * wi_l[..., 2] > 0
    return np.where(same[:, None], kd / np.pi, 0.0).astype(F)


def _lambert_pdf(wo_l, wi_l):
    same = wo_l[..., 2] * wi_l[..., 2] > 0
    return np.where(same, np.abs(wi_l[..., 2]) / np.pi, 0.0).astype(F)


def _area_le(lights, light_id, ng, w):
    lid = np.maximum(light_id, 0)
    emit = _np(lights.emit)[lid]
    ts = _np(lights.two_sided)[lid]
    ok = (light_id >= 0) & (ts | (_dot(ng, w) > 0))
    return np.where(ok[:, None], emit, 0.0).astype(F)


def _estimate_direct(scene, lights, kd, frame_t, frame_b, p, ns, ng, wo,
                     lt, pmf, u_light, u_bsdf, active, world_radius):
    n = len(lt)
    ld = np.zeros((n, 3), F)
    t, b = frame_t, frame_b

    def to_local(v):
        return np.stack([_dot(v, t), _dot(v, b), _dot(v, ns)], -1).astype(F)

    def to_world(v):
        return (v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * ns).astype(F)

    ls = _sample_li(lights, scene, lt, p, u_light, world_radius)
    wo_l = to_local(wo)
    wi_l = to_local(ls["wi"])
    f = _lambert_f(kd, wo_l, wi_l) * np.abs(_dot(ls["wi"], ns))[:, None]
    scat_pdf = _lambert_pdf(wo_l, wi_l)
    lum_li = 0.212671 * ls["li"][:, 0] + 0.715160 * ls["li"][:, 1] + 0.072169 * ls["li"][:, 2]
    lum_f = 0.212671 * f[:, 0] + 0.715160 * f[:, 1] + 0.072169 * f[:, 2]
    usable = active & (ls["pdf"] > 0) & (lum_li > 0) & (lum_f > 0)
    o_sh = _offset_origin(p, ng, ls["wi"])
    t_max = np.maximum(ls["dist"] * (1 - 1e-3), 1e-4)
    occ = occluded(scene, o_sh, ls["wi"], t_max)
    vis = usable & ~occ
    w_l = np.where(ls["is_delta"], 1.0, _power_heuristic(ls["pdf"], scat_pdf)).astype(F)
    ld += np.where(vis[:, None], f * ls["li"] * (w_l / np.maximum(ls["pdf"], 1e-12))[:, None], 0.0)

    # bsdf strategy (lambert: cosine sample)
    wi_b_l = _cos_hemisphere(u_bsdf)
    wi_b_l = np.where((wo_l[..., 2] < 0)[:, None], wi_b_l * np.array([1, 1, -1], F), wi_b_l)
    pdf_b = _lambert_pdf(wo_l, wi_b_l)
    f_b = _lambert_f(kd, wo_l, wi_b_l)
    wi_b = to_world(wi_b_l)
    f_b = f_b * np.abs(_dot(wi_b, ns))[:, None]
    lum_fb = 0.212671 * f_b[:, 0] + 0.715160 * f_b[:, 1] + 0.072169 * f_b[:, 2]
    try_b = active & ~ls["is_delta"] & (pdf_b > 0) & (lum_fb > 0)
    o_b = _offset_origin(p, ng, wi_b)
    hb = intersect(scene, o_b, wi_b)
    same_light = hb["valid"] & (hb["light"] == lt)
    li_surf = _area_le(lights, hb["light"], hb["ng"], -wi_b)
    to_l = hb["p"] - p
    d2 = np.maximum(np.sum(to_l * to_l, -1), 1e-12)
    wi_n = to_l / np.sqrt(d2)[:, None]
    cos_l = np.abs(_dot(hb["ng"], -wi_n))
    pdf_lb = (d2 / (np.maximum(cos_l, 1e-8)
                    * np.maximum(_np(lights.total_area)[np.maximum(lt, 0)], 1e-12))).astype(F)
    pdf_lb = np.where(cos_l < 1e-7, 0.0, pdf_lb)
    w_b = _power_heuristic(pdf_b, np.where(same_light, pdf_lb, 0.0))
    ok_b = try_b & same_light & (pdf_lb > 0)
    ld += np.where(ok_b[:, None],
                   f_b * li_surf * (w_b / np.maximum(pdf_b, 1e-12))[:, None], 0.0)
    return (ld / np.maximum(pmf, 1e-12)[:, None]).astype(F)


# ---------------------------------------------------------------- render

def render_direct(scene, camera, width, height, spp, seed=0):
    """Direct-lighting render with the 'random' sampler — bitwise-matched
    RNG streams vs the device renderer."""
    hw = width * height
    img = np.zeros((hw, 3), F)
    r2c = _np(camera.raster_to_camera.m)
    c2w = _np(camera.camera_to_world.m)
    world_radius = float(_np(scene.world_radius))
    lights = scene.lights
    n_lights = int(_np(lights.kind).shape[0])
    kd_table = _np(scene.materials.kd)

    pix = np.arange(hw, dtype=np.uint32)
    for s in range(spp):
        u_film = _u2(seed, pix, s, smp.DIM_FILM)
        px = (pix % width).astype(F)
        py = (pix // width).astype(F)
        praster = np.stack([px + u_film[:, 0], py + u_film[:, 1],
                            np.zeros(hw, F)], -1)  # box: +0.5+(u-0.5) = +u
        pc = praster @ r2c[:3, :3].T + r2c[:3, 3]
        wdiv = (praster @ r2c[3, :3].T + r2c[3, 3]).astype(F)
        pc = (pc / wdiv[:, None]).astype(F)
        d_cam = _norm(pc)
        o = np.broadcast_to(c2w[:3, 3], (hw, 3)).astype(F)
        d = _norm(d_cam @ c2w[:3, :3].T)

        hit = intersect(scene, o, d)
        wo = -d
        le = np.where(hit["valid"][:, None],
                      _area_le(lights, hit["light"], hit["ng"], wo), 0.0).astype(F)
        active = hit["valid"] & (hit["mat"] >= 0)
        t, b = _frame(hit["ns"], hit["dpdu"])
        kd = kd_table[np.maximum(hit["mat"], 0)]

        u_sel = _u1(seed, pix, s, smp.bounce_dim(0, 5))
        lt = np.minimum((u_sel * n_lights).astype(np.int32), n_lights - 1)
        pmf = np.full(hw, 1.0 / n_lights, F)
        u_light = _u2(seed, pix, s, smp.bounce_dim(0, 3))
        u_bsdf = _u2(seed, pix, s, smp.bounce_dim(0, 0))
        ld = _estimate_direct(scene, lights, kd, t, b, hit["p"], hit["ns"], hit["ng"],
                              wo, lt, pmf, u_light, u_bsdf, active, world_radius)
        img += le + np.where(active[:, None], ld, 0.0)
    return (img / spp).reshape(height, width, 3)
