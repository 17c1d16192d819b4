"""A plain wavefront path tracer for the configurations' scenes: matte
(Lambertian), mirror and smooth glass surfaces, quad area lights chosen
uniformly, a pinhole camera and a box filter one pixel wide, every
sample of every pixel in one wavefront.

Its estimator is the one the traffic names: next-event estimation with
the power heuristic against the BSDF sample at every bounce, Russian
roulette from bounce `rr_start` on, and from bounce `compact_from` on a
wavefront that keeps, of its live lanes, the ones whose compaction
uniform is least, as many as a width fixed in advance, scaling their
throughput by live / kept when that is over one. Rays are traced by
testing every triangle and every sphere.

`lowp` makes the control: the same tracer with every ray it traces
rounded to bfloat16, and each lane's radiance too."""
from __future__ import annotations

import math

import torch

from . import sampler as smp
from .scene import GLASS, MATTE, MIRROR

RAY_EPS = 1e-4
INV_PI = 1.0 / math.pi
LUM = (0.212671, 0.715160, 0.072169)


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v):
    return v / torch.clamp(v.norm(dim=-1, keepdim=True), min=1e-20)


def lum(c):
    return c[..., 0] * LUM[0] + c[..., 1] * LUM[1] + c[..., 2] * LUM[2]


def offset(p, ng, w):
    """A spawned ray's origin, pushed off the surface along ng to w's side."""
    eps = RAY_EPS * torch.clamp(p.abs().amax(-1), min=1.0)
    return p + torch.where(dot(w, ng) < 0.0, -eps, eps)[..., None] * ng


def power(a, b):
    return a * a / torch.clamp(a * a + b * b, min=1e-20)


def basis(n):
    """A unit vector perpendicular to unit n (Duff et al.)."""
    s = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    return torch.stack([1.0 + s * n[..., 0] ** 2 * a, s * n[..., 0] * n[..., 1] * a,
                        -s * n[..., 0]], -1)


# ---------------------------------------------------------------- tracing

def _triangles(sc, o, d, t_max):
    """Closest triangle of each ray (Moller-Trumbore over every triangle):
    (t, index, b1, b2), t = inf where none."""
    n = o.shape[0]
    best = torch.full((n,), math.inf, device=o.device)
    idx = torch.zeros(n, dtype=torch.int64, device=o.device)
    b1s, b2s = torch.zeros_like(best), torch.zeros_like(best)
    for j in range(sc.tri.shape[0]):
        p0, p1, p2 = sc.tri[j]
        e1, e2 = p1 - p0, p2 - p0
        pv = cross(d, e2.expand_as(d))
        det = dot(pv, e1)
        ok = det.abs() > 1e-12
        inv = 1.0 / torch.where(ok, det, 1.0)
        tv = o - p0
        b1 = dot(tv, pv) * inv
        qv = cross(tv, e1.expand_as(tv))
        b2 = dot(d, qv) * inv
        t = dot(qv, e2.expand_as(qv)) * inv
        hit = ok & (b1 >= 0) & (b2 >= 0) & (b1 + b2 <= 1) & (t > RAY_EPS) & (t < t_max) \
            & (t < best)
        best = torch.where(hit, t, best)
        idx = torch.where(hit, j, idx)
        b1s, b2s = torch.where(hit, b1, b1s), torch.where(hit, b2, b2s)
    return best, idx, b1s, b2s


def _sphere_t(c, r, o, d, t_lo, t_hi):
    """Nearest root of the ray against sphere (c, r) in (t_lo, t_hi), inf if none."""
    oc = o - c
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    cc = dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cc
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = torch.where(b < 0.0, -0.5 * (b - sq), -0.5 * (b + sq))
    r0 = torch.where(a != 0.0, q / torch.where(a != 0.0, a, 1.0), math.inf)
    r1 = torch.where(q != 0.0, cc / torch.where(q != 0.0, q, 1.0), math.inf)
    t0, t1 = torch.minimum(r0, r1), torch.maximum(r0, r1)
    has = disc >= 0.0
    in0 = has & (t0 > t_lo) & (t0 < t_hi)
    in1 = has & (t1 > t_lo) & (t1 < t_hi)
    return torch.where(in0, t0, torch.where(in1, t1, math.inf))


class Hit:
    """Closest hit of rays: valid, t, p, ng, frame (tangent, bitangent,
    normal), material row and light index (-1 where none)."""

    def __init__(self, sc, o, d, t_max):
        t, tri, b1, b2 = _triangles(sc, o, d, t_max)
        c = sc.tri[tri]
        p0, p1, p2 = c[:, 0], c[:, 1], c[:, 2]
        p = (1.0 - b1 - b2)[:, None] * p0 + b1[:, None] * p1 + b2[:, None] * p2
        ng = normalize(cross(p1 - p0, p2 - p0))
        uv = sc.tri_uv[tri]
        duv02, duv12 = uv[:, 0] - uv[:, 2], uv[:, 1] - uv[:, 2]
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        flat = det.abs() <= 1e-10
        dpdu = (duv12[:, 1:2] * (p0 - p2) - duv02[:, 1:2] * (p1 - p2)) \
            / torch.where(flat, 1.0, det)[:, None]
        dpdu = torch.where(flat[:, None], basis(ng), normalize(dpdu))
        mat, light = sc.tri_mat[tri], sc.tri_light[tri]
        for k, (r, m) in enumerate(zip(sc.sph_r, sc.sph_mat)):
            ts = _sphere_t(sc.sph_c[k], r, o, d, RAY_EPS, torch.minimum(t, t_max))
            take = ts < t
            rel = o + ts[:, None] * d - sc.sph_c[k]
            rel = torch.where(take[:, None], rel, ng)          # keep the math finite
            rel = rel * (r / torch.clamp(rel.norm(dim=-1), min=1e-12))[:, None]
            n_s = normalize(rel)
            tan = torch.stack([-rel[:, 1], rel[:, 0], torch.zeros_like(ts)], -1)
            tan = torch.where((dot(tan, tan) < 1e-14)[:, None], basis(n_s), normalize(tan))
            t = torch.where(take, ts, t)
            p = torch.where(take[:, None], sc.sph_c[k] + rel, p)
            ng = torch.where(take[:, None], n_s, ng)
            dpdu = torch.where(take[:, None], tan, dpdu)
            mat = torch.where(take, m, mat)
            light = torch.where(take, -1, light)
        self.valid = torch.isfinite(t)
        self.t, self.p, self.ng = t, p, ng
        self.mat = torch.where(self.valid, mat, -1)
        self.light = torch.where(self.valid, light, -1)
        tangent = normalize(dpdu - dot(dpdu, ng)[:, None] * ng)
        self.b = normalize(cross(ng, tangent))
        self.t_ax = cross(self.b, ng)
        self.n = ng

    def local(self, v):
        return torch.stack([dot(v, self.t_ax), dot(v, self.b), dot(v, self.n)], -1)

    def world(self, v):
        return v[:, 0:1] * self.t_ax + v[:, 1:2] * self.b + v[:, 2:3] * self.n

    def take(self, order):
        h = Hit.__new__(Hit)
        for k, v in vars(self).items():
            setattr(h, k, v[order])
        return h


def occluded(sc, o, d, t_max):
    """Whether anything lies on each ray within (RAY_EPS, t_max)."""
    t, _, _, _ = _triangles(sc, o, d, t_max)
    occ = torch.isfinite(t)
    for k, r in enumerate(sc.sph_r):
        occ = occ | torch.isfinite(_sphere_t(sc.sph_c[k], r, o, d, RAY_EPS, t_max))
    return occ


# ---------------------------------------------------------------- shading

def fresnel(cos_i, eta):
    """Unpolarised reflectance of a smooth dielectric of index eta in vacuum."""
    ci = torch.clamp(cos_i, -1.0, 1.0)
    enter = ci > 0.0
    ei = torch.where(enter, 1.0, eta)
    et = torch.where(enter, eta, 1.0)
    ci = ci.abs()
    st = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    ct = torch.sqrt(torch.clamp(1.0 - st * st, min=0.0))
    rpar = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-12)
    rper = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-12)
    return torch.where(st >= 1.0, 1.0, 0.5 * (rpar * rpar + rper * rper))


def cosine_dir(u):
    """Cosine-weighted direction about +z (Shirley-Chiu concentric disk)."""
    x, y = 2.0 * u[:, 0] - 1.0, 2.0 * u[:, 1] - 1.0
    use_x = x.abs() > y.abs()
    r = torch.where(use_x, x, y)
    phi = torch.where(use_x, (math.pi / 4) * torch.where(x != 0, y / torch.where(x != 0, x, 1.0), 0.0),
                      math.pi / 2 - (math.pi / 4) * torch.where(y != 0, x / torch.where(y != 0, y, 1.0), 0.0))
    zero = (x == 0) & (y == 0)
    dx = torch.where(zero, 0.0, r * torch.cos(phi))
    dy = torch.where(zero, 0.0, r * torch.sin(phi))
    return torch.stack([dx, dy, torch.sqrt(torch.clamp(1.0 - dx * dx - dy * dy, min=0.0))], -1)


def matte_f(kd, wo, wi):
    same = wo[:, 2] * wi[:, 2] > 0.0
    return torch.where(same[:, None], kd * INV_PI, 0.0), torch.where(same, wi[:, 2].abs() * INV_PI, 0.0)


def bsdf_sample(kind, kd, kr, kt, eta, wo, u_lobe, u2):
    """(wi, f, pdf, specular, transmitted) in the local frame."""
    wi_m = cosine_dir(u2)
    wi_m = torch.where((wo[:, 2] < 0.0)[:, None], wi_m * wi_m.new_tensor([1.0, 1.0, -1.0]), wi_m)
    f_m, _ = matte_f(kd, wo, wi_m)
    pdf_m = wi_m[:, 2].abs() * INV_PI
    mirror = torch.stack([-wo[:, 0], -wo[:, 1], wo[:, 2]], -1)
    cos_m = torch.clamp(mirror[:, 2].abs(), min=1e-8)[:, None]
    f_mirror = kr / cos_m
    # smooth glass: reflect with the Fresnel reflectance, else refract
    fr = fresnel(wo[:, 2], eta)
    refl = u_lobe < fr
    enter = wo[:, 2] > 0.0
    rel = torch.where(enter, 1.0 / eta, eta)
    nz = torch.where(enter, 1.0, -1.0)
    cos_i = wo[:, 2] * nz
    sin2_t = rel * rel * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    ok_t = sin2_t < 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wt = -rel[:, None] * wo
    wt = torch.stack([wt[:, 0], wt[:, 1], wt[:, 2] + (rel * cos_i - cos_t) * nz], -1)
    f_t = (1.0 - fr)[:, None] * kt * (rel * rel / torch.clamp(wt[:, 2].abs(), min=1e-8))[:, None]
    f_t = torch.where(ok_t[:, None], f_t, 0.0)
    wi_g = torch.where(refl[:, None], mirror, wt)
    f_g = torch.where(refl[:, None], (fr[:, None] / cos_m) * kr, f_t)
    pdf_g = torch.where(refl, fr, (1.0 - fr) * ok_t.to(fr.dtype))
    k3 = kind[:, None]
    wi = torch.where(k3 == MATTE, wi_m, torch.where(k3 == MIRROR, mirror, wi_g))
    f = torch.where(k3 == MATTE, f_m, torch.where(k3 == MIRROR, f_mirror, f_g))
    pdf = torch.where(kind == MATTE, pdf_m, torch.where(kind == MIRROR, 1.0, pdf_g))
    spec = kind != MATTE
    trans = (kind == GLASS) & ~refl & ok_t
    return wi, f, pdf, spec, trans


# ----------------------------------------------------------------- lights

def light_sample(sc, emit, lt, p, u2):
    """A point on light lt by area, seen from p: (wi, radiance, solid-angle
    pdf, distance)."""
    wi = torch.zeros_like(p)
    rad, pdf, dist = torch.zeros_like(p), torch.zeros_like(p[:, 0]), torch.zeros_like(p[:, 0])
    for i, (ids, cdf, area) in enumerate(zip(sc.light_tris, sc.light_cdf, sc.light_area)):
        mine = lt == i
        u0 = u2[:, 0]
        slot = sum((u0 >= c).to(torch.int64) for c in cdf[:-1]) if len(cdf) > 1 \
            else torch.zeros_like(lt)
        edges = torch.tensor([0.0] + cdf, device=p.device)
        lo, hi = edges[slot], edges[slot + 1]
        u0 = (u0 - lo) / torch.clamp(hi - lo, min=1e-9)
        c = sc.tri[torch.tensor(ids, device=p.device)[slot]]
        su = torch.sqrt(torch.clamp(u0, min=0.0))
        b0, b1 = 1.0 - su, u2[:, 1] * su
        q = b0[:, None] * c[:, 0] + b1[:, None] * c[:, 1] + (1.0 - b0 - b1)[:, None] * c[:, 2]
        nl = normalize(cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]))
        to = q - p
        d2 = torch.clamp(dot(to, to), min=1e-12)
        dd = torch.sqrt(d2)
        w = to / dd[:, None]
        cos_l = -dot(nl, w)
        pd = torch.where(cos_l.abs() < 1e-7, 0.0,
                         d2 / (torch.clamp(cos_l.abs(), min=1e-8) * max(area, 1e-12)))
        wi = torch.where(mine[:, None], w, wi)
        rad = torch.where((mine & (cos_l > 0.0))[:, None], emit[i], rad)
        pdf = torch.where(mine, pd, pdf)
        dist = torch.where(mine, dd, dist)
    return wi, rad, pdf, dist


def light_pdf(sc, light, p_from, p_on, n_on):
    """Solid-angle pdf with which light `light` is sampled from p_from at
    the point p_on (normal n_on) on it; 0 where light < 0."""
    area = torch.tensor(sc.light_area + [1.0], device=p_on.device)[torch.where(light >= 0, light, -1)]
    to = p_on - p_from
    d2 = torch.clamp(dot(to, to), min=1e-12)
    cos_l = dot(n_on, to / torch.sqrt(d2)[:, None]).abs()
    pdf = d2 / (torch.clamp(cos_l, min=1e-8) * torch.clamp(area, min=1e-12))
    return torch.where((light >= 0) & (cos_l >= 1e-7), pdf, 0.0)


def emitted(sc, emit, hit, d, prev_p, prev_pdf, prev_spec, counts):
    """Radiance of an area light a ray hit, MIS-weighted against the light
    sample that could have found it."""
    lid = torch.clamp(hit.light, min=0)
    lit = (hit.light >= 0) & (dot(hit.ng, -d) > 0.0)
    le = torch.where(lit[:, None], emit[lid], 0.0)
    pdf_nee = light_pdf(sc, hit.light, prev_p, hit.p, hit.ng) / sc.n_lights
    w = torch.where(prev_spec, 1.0, power(prev_pdf, pdf_nee))
    return torch.where(counts[:, None], le * w[:, None], 0.0)


# ------------------------------------------------------------- integrator

def compact_width(n0, bounce, compact_from, floor=2048):
    """Lanes kept at `bounce`: half as many each bounce from compact_from,
    eight times fewer again from the fourth, at most 128 times fewer, and
    never under `floor` (nor over n0)."""
    shift = bounce - compact_from + 1
    shift = min(shift + 2 if shift >= 4 else shift, 7)
    return max(min(n0 >> shift, n0), min(floor, n0))


def radiance(sc, o, d, pixel, sample, seed, depth, rr_start, compact_from, kd, emit,
             lowp=False):
    """Radiance along camera rays (N, 3) of lanes (pixel, sample)."""
    q = bf16 if lowp else (lambda x: x)
    n0 = n = o.shape[0]
    dev = o.device
    st = smp.Stream(seed, pixel, sample)
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_spec = torch.ones_like(active)
    prev_pdf = torch.zeros(n, device=dev)
    prev_p = o
    eta_sc = torch.ones(n, device=dev)
    gid = torch.arange(n, device=dev)
    total = None
    hit = Hit(sc, q(o), q(d), torch.full((n,), math.inf, device=dev))
    for b in range(depth):
        if compact_from is not None and b >= compact_from:
            m = compact_width(n0, b, compact_from)
            if m < n:
                key = torch.where(active, st.u1(smp.bounce_dim(b, smp.SLOT_COMPACT)), 2.0)
                order = torch.argsort(key, stable=True)[:m]
                live = active.to(torch.float32).sum()
                total = (torch.zeros((n0, 3), device=dev) if total is None else total) \
                    .index_add(0, gid, L)
                beta, eta_sc, active, gid, d, prev_p, prev_pdf, prev_spec = (
                    x[order] for x in (beta, eta_sc, active, gid, d, prev_p, prev_pdf,
                                       prev_spec))
                pixel, sample = pixel[order], sample[order]
                hit = hit.take(order)
                L = torch.zeros((m, 3), device=dev)
                beta = torch.where(active[:, None], beta * torch.clamp(live / m, min=1.0), beta)
                n = m
                st = smp.Stream(seed, pixel, sample)
        wo = -d
        L = L + beta * emitted(sc, emit, hit, d, prev_p, prev_pdf, prev_spec, active)
        active = active & hit.valid & (hit.mat >= 0)
        mat = torch.clamp(hit.mat, min=0)
        kind, kd_h = sc.kind[mat], kd[mat]
        wo_l = hit.local(wo)
        # next-event estimation: a light, a point on it, its shadow ray
        nl = sc.n_lights
        lt = torch.clamp((st.u1(smp.bounce_dim(b, smp.SLOT_SELECT)) * nl).to(torch.int64),
                         max=nl - 1)
        wi_l, li, pdf_l, dist = light_sample(sc, emit, lt, hit.p,
                                             st.u2(smp.bounce_dim(b, smp.SLOT_LIGHT2)))
        f_l, pdf_s = matte_f(kd_h, wo_l, hit.local(wi_l))
        matte = (kind == MATTE)[:, None]
        f_l = torch.where(matte, f_l, 0.0) * dot(wi_l, hit.n).abs()[:, None]
        pdf_s = torch.where(kind == MATTE, pdf_s, 0.0)
        usable = active & (pdf_l > 0.0) & (lum(li) > 0.0) & (lum(f_l) > 0.0)
        o_sh = offset(hit.p, hit.ng, wi_l)
        tmax_sh = torch.where(usable, torch.clamp(dist * (1.0 - 1e-3), min=RAY_EPS), -1.0)
        nee = f_l * li * (power(pdf_l, pdf_s) / torch.clamp(pdf_l, min=1e-12))[:, None]
        nee = torch.where((usable & active)[:, None], beta * nee * nl, 0.0)
        # the BSDF sample continues the path
        wi_loc, f, pdf, spec, trans = bsdf_sample(
            kind, kd_h, sc.kr[mat], sc.kt[mat], sc.eta[mat], wo_l,
            st.u1(smp.bounce_dim(b, smp.SLOT_LOBE)), st.u2(smp.bounce_dim(b, smp.SLOT_BSDF2)))
        wi = hit.world(wi_loc)
        good = active & (pdf > 0.0) & (lum(f) > 0.0)
        beta = torch.where(good[:, None],
                           beta * f * (dot(wi, hit.n).abs() / torch.clamp(pdf, min=1e-12))[:, None],
                           beta)
        active = good
        e2 = sc.eta[mat] ** 2
        eta_sc = torch.where(trans, eta_sc * torch.where(wo_l[:, 2] > 0.0, e2,
                                                         1.0 / torch.clamp(e2, min=1e-8)), eta_sc)
        if b >= rr_start:
            qrr = torch.clamp(1.0 - (beta * eta_sc[:, None]).amax(-1), min=0.05)
            live = st.u1(smp.bounce_dim(b, smp.SLOT_RR)) >= qrr
            beta = torch.where((active & live)[:, None],
                               beta / torch.clamp(1.0 - qrr, min=1e-6)[:, None], beta)
            active = active & live
        prev_p, prev_pdf, prev_spec = hit.p, pdf, spec
        o, d = offset(hit.p, hit.ng, wi), wi
        hit = Hit(sc, q(o), q(d), torch.where(active, math.inf, -1.0))
        occ = occluded(sc, q(o_sh), q(wi_l), tmax_sh)
        L = L + torch.where((usable & ~occ)[:, None], nee, 0.0)
    L = L + beta * emitted(sc, emit, hit, d, prev_p, prev_pdf, prev_spec, active)
    if total is not None:
        L = total.index_add(0, gid, L)
    return q(L)


def lanes(width, height, spp, device):
    """(pixel, sample) of every lane, sample-major: lane s * H * W + pixel."""
    hw = width * height
    pixel = torch.arange(hw, device=device).repeat(spp)
    sample = torch.arange(spp, device=device).repeat_interleave(hw)
    return pixel, sample


def camera_rays(cam, pixel, st):
    """Rays through each lane's film position: the pixel's corner plus a
    uniform offset in it (the box filter one pixel wide)."""
    w, h = cam.width, cam.height
    u = st.u2(smp.DIM_FILM)
    fx = (pixel % w).to(torch.float32) + 0.5 + (u[:, 0] - 0.5)
    fy = (pixel // w).to(torch.float32) + 0.5 + (u[:, 1] - 0.5)
    aspect = w / h
    sx_half, sy_half = (aspect, 1.0) if aspect > 1.0 else (1.0, 1.0 / aspect)
    sx = -sx_half + fx * (2.0 * sx_half / w)
    sy = sy_half - fy * (2.0 * sy_half / h)
    d_cam = torch.stack([sx * cam.tan_half, sy * cam.tan_half, torch.ones_like(sx)], -1)
    d = normalize(normalize(d_cam) @ cam.rot.T)
    o = torch.tensor(cam.pos, device=d.device).expand_as(d)
    return o, d


def render(sc, cam, spp, seed, depth, rr_start, compact_from, kd=None, emit=None,
           lowp=False):
    """The (H, W, 3) image: each pixel the mean of its spp samples."""
    kd = sc.kd if kd is None else kd
    emit = sc.emit if emit is None else emit
    pixel, sample = lanes(cam.width, cam.height, spp, sc.tri.device)
    o, d = camera_rays(cam, pixel, smp.Stream(seed, pixel, sample))
    rad = radiance(sc, o, d, pixel, sample, seed, depth, rr_start, compact_from, kd, emit,
                   lowp)
    return rad.reshape(spp, cam.height, cam.width, 3).sum(0) / spp
