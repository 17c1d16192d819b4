"""Bidirectional path tracing (counterpart of pbrt_tpu/integrate/bdpt.py).

Subpaths are structures of arrays, one (N, ...) tensor per vertex and
field, filled by masked wavefront walks; every (s, t) connection strategy
is unrolled in Python, so every vertex access is a static index.

Strategies:
  s=0          the camera subpath hits a light (or escapes to the
               infinite light)
  s=1          a light point sampled from camera vertex t-1
  t=1          light vertex s-1 connected to a sampled point on the lens
               (splatted to the film)
  s≥1, t≥2     vertex-to-vertex connection with the G·V term

MIS weights use the forward/reverse area-density ratio recurrence; the
connection's endpoint overrides are passed explicitly. Escaped camera
subpaths end in VTX_ENV vertices on a far sphere (2 × world radius), and
infinite-light subpaths carry its density corrections. Media: a scatter
of the scene's global medium (medium 0) makes a VTX_MEDIUM vertex (HG
phase, no cos in its density conversions) and every connection carries
the medium's Tr; per-interface medium switching is not tracked, as in
the reference.

Every scene query goes through geom.scene: the closest-hit kernel for
each walk step, the any-hit kernel for each connection. Dead lanes are
passed to the tracers as inactive, which changes no result.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import camera_pdf_we, camera_sample_wi, generate_rays_weighted
from ..core import samplers as smp
from ..core import vecmath as vm
from ..core.rng import hash_combine
from ..core.spectrum import luminance
from ..core.types import PI, f32
from ..film import film as filmmod
from ..geom import scene as scenemod
from ..lights import lights as lightsmod
from ..lights.lights import LIGHT_INFINITE
from ..shade import materials as matmod
from ..shade import media as medmod
from . import common

VTX_CAMERA = 0
VTX_LIGHT = 1
VTX_SURFACE = 2
VTX_ENV = 3       # a camera subpath's escape to the infinite light, on the far sphere
VTX_MEDIUM = 4    # a phase-function vertex in the global medium
DELTA_KINDS = (lightsmod.LIGHT_POINT, lightsmod.LIGHT_SPOT, lightsmod.LIGHT_DISTANT,
               lightsmod.LIGHT_GONIO, lightsmod.LIGHT_PROJECTION)
SHADOW_SCALE = f32(1.0 - 1e-3)   # a connection's shadow ray stops this far along it


class Path(NamedTuple):
    """A subpath: each field a list over the V vertices of (N, ...) tensors."""
    vtype: list        # (N,) int64
    p: list            # (N, 3)
    ng: list           # (N, 3)
    ns: list           # (N, 3)
    uv: list           # (N, 2)
    dpdu: list         # (N, 3)
    beta: list         # (N, 3)
    pdf_fwd: list      # (N,) area density
    pdf_rev: list      # (N,)
    delta: list        # (N,) bool
    mid: list          # (N,) material id
    light_id: list     # (N,) light at the vertex (emissive hit, light origin)
    valid: list        # (N,) bool
    n_vertices: torch.Tensor   # (N,)


def _empty_path(n, v, device):
    f = dict(dtype=torch.float32, device=device)
    i = dict(dtype=torch.int64, device=device)
    z3 = torch.zeros((n, 3), **f)
    zf = torch.zeros((n,), **f)
    zb = torch.zeros((n,), dtype=torch.bool, device=device)
    m1 = torch.full((n,), -1, **i)
    return Path(vtype=[torch.zeros((n,), **i)] * v, p=[z3] * v, ng=[z3] * v, ns=[z3] * v,
                uv=[torch.zeros((n, 2), **f)] * v, dpdu=[z3] * v, beta=[z3] * v,
                pdf_fwd=[zf] * v, pdf_rev=[zf] * v, delta=[zb] * v, mid=[m1] * v,
                light_id=[m1] * v, valid=[zb] * v, n_vertices=torch.zeros((n,), **i))


def _set_vertex(path, i, **kw):
    """The path with vertex i's fields in kw replaced."""
    upd = {}
    for k, v in kw.items():
        col = list(getattr(path, k))
        col[i] = v
        upd[k] = col
    return path._replace(**upd)


def _sel(mask, new, old):
    """where(mask) over a per-vertex field of any width."""
    return torch.where(mask[:, None] if new.dim() > 1 else mask, new, old)


def _set_where(path, i, mask, **kw):
    """Vertex i's fields in kw set where mask holds."""
    return _set_vertex(path, i, **{k: _sel(mask, v, getattr(path, k)[i]) for k, v in kw.items()})


def _disk_pdf(world_radius):
    """1 / (π r²) of the world disk, in float32 as the reference computes it."""
    return f32(1.0 / f32(PI * f32(world_radius * world_radius)))


def convert_density(pdf_solid, p_from, p_to, ng_to):
    """Solid-angle → area density."""
    w = p_to - p_from
    inv_d2 = 1.0 / torch.clamp(vm.length_squared(w), min=f32(1e-12))
    return pdf_solid * vm.absdot(vm.normalize(w), ng_to) * inv_d2


def _conv_to_vertex(pdf_solid, p_from, path, i):
    """convert_density toward path vertex i: cos is 1 at a medium vertex."""
    w = path.p[i] - p_from
    inv_d2 = 1.0 / torch.clamp(vm.length_squared(w), min=f32(1e-12))
    cos = torch.where(path.vtype[i] == VTX_MEDIUM, 1.0, vm.absdot(vm.normalize(w), path.ng[i]))
    return pdf_solid * cos * inv_d2


def _phase_g0(scene, n):
    """HG g of the global medium (medium 0), where BDPT's medium vertices live."""
    return medmod.phase_g(scene.media, torch.zeros((n,), dtype=torch.int64,
                                                   device=scene.device))


def _vertex_frame(scene, path, i):
    lp = matmod.resolve(scene.materials, path.mid[i], path.uv[i], path.p[i], scene.textures)
    b = vm.normalize(vm.cross(path.ns[i], path.dpdu[i]))
    return lp, common.Frame(t=vm.cross(b, path.ns[i]), b=b, n=path.ns[i])


def _vertex_f(scene, path, i, wo_dir, wi_dir):
    """BSDF at vertex i for wo (toward its predecessor) and wi (toward
    the other subpath); the HG phase at medium vertices."""
    lp, frame = _vertex_frame(scene, path, i)
    f = matmod.evaluate_f(lp, scene.materials.kinds_present, frame.to_local(wo_dir),
                          frame.to_local(wi_dir))
    if scene.media is not None:
        ph = medmod.hg_phase(vm.dot(wo_dir, wi_dir), _phase_g0(scene, f.shape[0]))
        f = torch.where((path.vtype[i] == VTX_MEDIUM)[:, None], ph[:, None], f)
    return f


def _vertex_pdf(scene, path, i, p_prev, p_next):
    """Solid-angle pdf of sampling p_next from vertex i having arrived
    from p_prev; the HG phase pdf at medium vertices."""
    wo = vm.normalize(p_prev - path.p[i])
    wi = vm.normalize(p_next - path.p[i])
    lp, frame = _vertex_frame(scene, path, i)
    pdf_sa = matmod.pdf(lp, scene.materials.kinds_present, frame.to_local(wo),
                        frame.to_local(wi))
    if scene.media is not None:
        ph = medmod.hg_phase(vm.dot(wo, wi), _phase_g0(scene, pdf_sa.shape[0]))
        pdf_sa = torch.where(path.vtype[i] == VTX_MEDIUM, ph, pdf_sa)
    return pdf_sa


class _Rays:
    """The rays a frame traces that carry a share: live walk rays, and
    connection rays whose unoccluded contribution is not zero."""
    def __init__(self, device):
        self.n = torch.zeros((), dtype=torch.float32, device=device)

    def add(self, mask):
        self.n = self.n + mask.to(torch.float32).sum()
        return mask


def _walk(scene, cfg, pid, sid, o, d, beta0, pdf_dir0, mode, dim_base, max_v, path, rays):
    """Random walk filling vertices 1..max_v-1 of `path`; mode "camera"
    (radiance) or "light" (importance: the shading-normal correction)."""
    lights = scene.lights
    kinds = scene.materials.kinds_present
    media = scene.media
    n = pid.shape[0]
    scfg = cfg.sampler

    def s1(dim):
        return smp.sample_1d(scfg, pid, sid, dim)

    def s2(dim):
        return smp.sample_2d(scfg, pid, sid, dim)

    beta = beta0
    pdf_fwd_sa = pdf_dir0      # solid-angle pdf of the current direction
    active = luminance(beta0) > 0
    nv = torch.ones((n,), dtype=torch.int64, device=pid.device)
    for i in range(1, max_v):
        hit = scenemod.intersect(scene, o, d, active=rays.add(active))
        if media is not None:
            # a scatter of the global medium before the surface: a phase vertex
            seg_dist = torch.where(hit.valid, hit.t, 2.0 * scene.world_radius)
            key = hash_combine(pid, sid, dim_base + 8 * i)
            m_sampled, m_t, m_w = medmod.medium_sample(
                media, torch.zeros_like(pid), o, d, seg_dist, s1(dim_base + 8 * i + 4),
                s1(dim_base + 8 * i + 5), key)
            m_sampled = m_sampled & active
            beta = torch.where(active[:, None], beta * m_w, beta)
            p_med = o + m_t[:, None] * d
            # area density at the medium vertex: no cos
            pdf_med = pdf_fwd_sa / torch.clamp(vm.length_squared(p_med - o), min=f32(1e-12))
            path = _set_where(path, i, m_sampled, vtype=torch.full_like(pid, VTX_MEDIUM),
                              p=p_med, ng=-d, ns=-d, beta=beta, pdf_fwd=pdf_med)
            path = _set_vertex(path, i, valid=path.valid[i] | m_sampled)
            nv = torch.where(m_sampled, i + 1, nv)
            wi_med, ph_pdf = medmod.hg_sample(d, _phase_g0(scene, n), s2(dim_base + 8 * i + 6))
            rev_med = _conv_to_vertex(ph_pdf, p_med, path, i - 1)
            path = _set_vertex(path, i - 1,
                               pdf_rev=torch.where(m_sampled, rev_med, path.pdf_rev[i - 1]))
        else:
            m_sampled = torch.zeros_like(active)
        live = active & hit.valid & (hit.material_id >= 0) & ~m_sampled
        pdf_area = convert_density(pdf_fwd_sa, o, hit.p, hit.ng)
        if mode == "camera" and lights.env_index >= 0:
            # an escaped ray becomes an infinite-light vertex on the far sphere
            miss = active & ~hit.valid & ~m_sampled
            p_env = o + d * (2.0 * scene.world_radius)
            path = _set_where(path, i, miss, vtype=torch.full_like(pid, VTX_ENV), p=p_env,
                              ng=-d, ns=-d, beta=beta,
                              pdf_fwd=convert_density(pdf_fwd_sa, o, p_env, -d),
                              light_id=torch.full_like(pid, lights.env_index))
            path = _set_vertex(path, i, valid=path.valid[i] | miss)
            nv = torch.where(miss, i + 1, nv)
        path = _set_where(path, i, live, vtype=torch.full_like(pid, VTX_SURFACE), p=hit.p,
                          ng=hit.ng, ns=hit.ns, uv=hit.uv, dpdu=hit.dpdu, beta=beta,
                          pdf_fwd=pdf_area, mid=hit.material_id, light_id=hit.light_id)
        path = _set_vertex(path, i, valid=path.valid[i] | live)
        nv = torch.where(live, i + 1, nv)

        # the continuation
        frame = common.shading_frame(hit)
        lp = matmod.resolve(scene.materials, hit.material_id, hit.uv, hit.p, scene.textures)
        wo = -d
        wo_l = frame.to_local(wo)
        wi_l, f, pdf, spec, _ = matmod.sample(lp, kinds, wo_l, s1(dim_base + 8 * i + 2),
                                              s2(dim_base + 8 * i))
        wi = frame.to_world(wi_l)
        good = live & (pdf > 0.0) & (luminance(f) > 0.0)
        path = _set_vertex(path, i, delta=torch.where(live, spec, path.delta[i]))
        # the reverse density at vertex i-1: sampling wo from wi
        pdf_rev_sa = torch.where(spec, 0.0, matmod.pdf(lp, kinds, wi_l, wo_l))
        pdf_rev_area = _conv_to_vertex(pdf_rev_sa, hit.p, path, i - 1)
        path = _set_vertex(path, i - 1,
                           pdf_rev=torch.where(live, pdf_rev_area, path.pdf_rev[i - 1]))
        cos_w = vm.absdot(wi, hit.ns)
        if mode == "light":     # shading-normal correction of importance transport
            cos_w = cos_w * (vm.absdot(wo, hit.ns) * vm.absdot(wi, hit.ng) / torch.clamp(
                vm.absdot(wo, hit.ng) * vm.absdot(wi, hit.ns), min=f32(1e-8)))
        beta = torch.where(good[:, None],
                           beta * f * (cos_w / torch.clamp(pdf, min=f32(1e-12)))[:, None], beta)
        pdf_fwd_sa = torch.where(spec, 0.0, pdf)
        active = good
        o = vm.offset_ray_origin(hit.p, hit.ng, wi)
        d = wi
        if media is not None:
            # medium lanes go on with the phase sample (beta unchanged: the
            # HG pdf equals its value)
            active = active | m_sampled
            pdf_fwd_sa = torch.where(m_sampled, ph_pdf, pdf_fwd_sa)
            o = torch.where(m_sampled[:, None], p_med, o)
            d = torch.where(m_sampled[:, None], wi_med, d)
    return path._replace(n_vertices=nv)


def generate_camera_subpath(scene, camera, cfg, pid, sid, pfilm, max_v, rays):
    n = pid.shape[0]
    u_lens = smp.sample_2d(cfg.sampler, pid, sid, smp.DIM_LENS)
    u_time = smp.sample_1d(cfg.sampler, pid, sid, smp.DIM_TIME)
    o, d, _, _ = generate_rays_weighted(camera, pfilm, u_lens, u_time)
    ones3 = torch.ones((n, 3), dtype=torch.float32, device=pid.device)
    path = _set_vertex(_empty_path(n, max_v, pid.device), 0,
                       vtype=torch.full_like(pid, VTX_CAMERA), p=o, ng=d, ns=d, beta=ones3,
                       pdf_fwd=torch.ones_like(o[:, 0]),
                       valid=torch.ones((n,), dtype=torch.bool, device=pid.device))
    _, pdf_dir = camera_pdf_we(camera, o, d)
    return _walk(scene, cfg, pid, sid, o, d, ones3, torch.clamp(pdf_dir, min=f32(1e-9)),
                 "camera", 100, max_v, path, rays), o, d


def generate_light_subpath(scene, cfg, pid, sid, max_v, rays):
    n = pid.shape[0]
    lights = scene.lights
    lt, pmf, _ = scene.light_power.sample_discrete(smp.sample_1d(cfg.sampler, pid, sid, 50))
    le = lightsmod.sample_le(lights, scene, lt, smp.sample_2d(cfg.sampler, pid, sid, 51),
                             smp.sample_2d(cfg.sampler, pid, sid, 53), scene.world_radius)
    kind = lights.kind[lt]
    is_delta_l = torch.zeros_like(lt, dtype=torch.bool)
    for k in DELTA_KINDS:
        is_delta_l = is_delta_l | (kind == k)
    pdf0 = pmf * le["pdf_pos"]
    path = _set_vertex(_empty_path(n, max_v, pid.device), 0,
                       vtype=torch.full_like(pid, VTX_LIGHT), p=le["o"], ng=le["ng_l"],
                       ns=le["ng_l"],
                       beta=le["le"] / torch.clamp(pdf0[:, None], min=f32(1e-12)),
                       pdf_fwd=pdf0, delta=is_delta_l, light_id=lt, valid=le["pdf_pos"] > 0)
    cos0 = vm.absdot(le["ng_l"], le["d"])
    beta_walk = le["le"] * cos0[:, None] / torch.clamp((pdf0 * le["pdf_dir"])[:, None],
                                                       min=f32(1e-12))
    o = vm.offset_ray_origin(le["o"], le["ng_l"], le["d"])
    lpath = _walk(scene, cfg, pid, sid, o, le["d"], beta_walk,
                  torch.clamp(le["pdf_dir"], min=0.0), "light", 300, max_v, path, rays)
    if lights.env_index >= 0:
        # infinite-light subpaths: the origin's density is the directional
        # one, the first vertex's the world disk's position density
        is_env = kind == LIGHT_INFINITE
        dens0 = pmf * lightsmod.env_pdf_li(lights, le["d"])
        lpath = _set_vertex(lpath, 0, pdf_fwd=torch.where(is_env, dens0, lpath.pdf_fwd[0]))
        if max_v > 1:
            corr1 = _disk_pdf(scene.world_radius) * vm.absdot(lpath.ng[1], le["d"])
            lpath = _set_vertex(lpath, 1, pdf_fwd=torch.where(is_env & lpath.valid[1], corr1,
                                                              lpath.pdf_fwd[1]))
    return lpath, lt, pmf


def _remap0(x):
    return torch.where(x != 0.0, x, 1.0)


def _connection(pa, pb):
    """Unit direction pa → pb and the squared distance (clamped)."""
    w = pb - pa
    d2 = torch.clamp(vm.length_squared(w), min=f32(1e-12))
    return w / torch.sqrt(d2)[:, None], d2


def _g_term(scene, pa, nga, ngb, wn, d2, med_a, med_b, tr_key, active):
    """Geometry term of the connection pa → pb (direction wn, squared
    distance d2) with visibility, the any-hit kernel on the `active`
    lanes (the others count as unoccluded), and the global medium's Tr;
    cos is 1 at a medium endpoint. Returns (N, 3)."""
    cos_a = torch.where(med_a, 1.0, vm.absdot(wn, nga))
    cos_b = torch.where(med_b, 1.0, vm.absdot(wn, ngb))
    g = cos_a * cos_b / d2
    dist = torch.sqrt(d2)
    occ = scenemod.occluded(scene, vm.offset_ray_origin(pa, nga, wn), wn,
                            t_max=torch.clamp(dist * SHADOW_SCALE, min=f32(1e-4)),
                            active=active)
    gv = torch.where(occ, 0.0, g)[:, None]
    if scene.media is not None:
        return gv * medmod.medium_tr(scene.media, torch.zeros_like(tr_key), pa, wn, dist, tr_key)
    return gv


def _mis_weight(cpath, lpath, s, t, overrides):
    """1 / (1 + Σ rᵢ) over the other strategies of the same path; the
    connection's endpoint densities in `overrides` (pt_rev, ptm_rev,
    qs_rev, qsm_rev)."""
    n = cpath.p[0].shape[0]
    if s + t == 2:
        return torch.ones((n,), dtype=torch.float32, device=cpath.p[0].device)
    sum_ri = torch.zeros((n,), dtype=torch.float32, device=cpath.p[0].device)
    no = torch.zeros((n,), dtype=torch.bool, device=sum_ri.device)

    def cam_rev(i):
        if i == t - 1 and "pt_rev" in overrides:
            return overrides["pt_rev"]
        if i == t - 2 and "ptm_rev" in overrides:
            return overrides["ptm_rev"]
        return cpath.pdf_rev[i]

    def light_rev(i):
        if i == s - 1 and "qs_rev" in overrides:
            return overrides["qs_rev"]
        if i == s - 2 and "qsm_rev" in overrides:
            return overrides["qsm_rev"]
        return lpath.pdf_rev[i]

    def cam_delta(i):
        return no if i == t - 1 else cpath.delta[i]

    def light_delta(i):
        return no if i == s - 1 else lpath.delta[i]

    ri = torch.ones_like(sum_ri)
    for i in range(t - 1, 0, -1):
        ri = ri * _remap0(cam_rev(i)) / _remap0(cpath.pdf_fwd[i])
        sum_ri = sum_ri + torch.where(~cam_delta(i) & ~cam_delta(i - 1), ri, 0.0)
    ri = torch.ones_like(sum_ri)
    for i in range(s - 1, -1, -1):
        ri = ri * _remap0(light_rev(i)) / _remap0(lpath.pdf_fwd[i])
        delta_prev = light_delta(i - 1) if i > 0 else lpath.delta[0]   # a delta light origin
        sum_ri = sum_ri + torch.where(~light_delta(i) & ~delta_prev, ri, 0.0)
    return 1.0 / (1.0 + sum_ri)


class BDPTConfig(NamedTuple):
    width: int = 64
    height: int = 64
    spp: int = 8
    max_depth: int = 4
    sampler: smp.SamplerConfig = smp.SamplerConfig(kind="random", spp=8)


def render(scene, camera, cfg: BDPTConfig, debug_strategies=False, return_stats=False):
    """BDPT render → (H, W, 3). With `debug_strategies`, also the per-(s,
    t) sums of the weighted and the unweighted contributions, each a mean
    over pixels and channels (key (s, t), or ("env0", t) for the escaped
    camera subpaths); with `return_stats`, also {"rays_traced"}."""
    h, w = cfg.height, cfg.width
    hw = h * w
    dev = scene.device
    lights = scene.lights
    power_dist = scene.light_power
    t_max_v = cfg.max_depth + 2
    s_max_v = cfg.max_depth + 1
    disk_pdf = _disk_pdf(scene.world_radius)
    f3 = dict(dtype=torch.float32, device=dev)
    img_acc = torch.zeros((hw, 3), **f3)
    splat_acc = torch.zeros((h, w, 3), **f3)
    strat_acc = {}
    rays = _Rays(dev)
    pid = torch.arange(hw, dtype=torch.int64, device=dev)
    scfg = cfg.sampler

    for sidx in range(cfg.spp):
        sid = torch.full((hw,), sidx, dtype=torch.int64, device=dev)

        def s1(dim):
            return smp.sample_1d(scfg, pid, sid, dim)

        def s2(dim):
            return smp.sample_2d(scfg, pid, sid, dim)

        u_film = s2(smp.DIM_FILM)
        px = (pid % w).to(torch.float32)
        py = torch.div(pid, w, rounding_mode="floor").to(torch.float32)
        pfilm = torch.stack([px + u_film[..., 0], py + u_film[..., 1]], -1)
        cpath, _, _ = generate_camera_subpath(scene, camera, cfg, pid, sid, pfilm, t_max_v,
                                              rays)
        lpath, _, _ = generate_light_subpath(scene, cfg, pid, sid, s_max_v, rays)
        L = torch.zeros((hw, 3), **f3)
        splat = torch.zeros((h, w, 3), **f3)

        def record(key, mask, contrib, wmis):
            if debug_strategies:
                a = strat_acc.get(key, (0.0, 0.0))
                strat_acc[key] = (
                    a[0] + torch.where(mask[:, None], contrib * wmis[:, None], 0.0).sum().double(),
                    a[1] + torch.where(mask[:, None], contrib, 0.0).sum().double())

        for t in range(2, t_max_v + 1):
            for s in range(0, s_max_v + 1):
                if s + t - 2 > cfg.max_depth:
                    continue
                c1, c2 = t - 1, t - 2     # the camera endpoint and its predecessor
                if s == 0:
                    if lights.env_index >= 0:
                        # an escaped camera subpath picks up the infinite light
                        is_env = cpath.valid[c1] & (cpath.vtype[c1] == VTX_ENV)
                        w_dir = vm.normalize(cpath.p[c1] - cpath.p[c2])
                        contrib_e = cpath.beta[c1] * lightsmod.env_radiance(lights, w_dir)
                        sel_env = power_dist.discrete_pdf(torch.full_like(pid, lights.env_index))
                        pt_rev_e = convert_density(
                            sel_env * lightsmod.env_pdf_li(lights, w_dir), cpath.p[c2],
                            cpath.p[c1], cpath.ng[c1])
                        cos_tm2 = torch.where(cpath.vtype[c2] == VTX_MEDIUM, 1.0,
                                              vm.absdot(cpath.ng[c2], w_dir))
                        wmis_e = _mis_weight(cpath, lpath, 0, t,
                                             dict(pt_rev=pt_rev_e, ptm_rev=disk_pdf * cos_tm2))
                        good = is_env & (luminance(contrib_e) > 0)
                        L = L + torch.where(good[:, None], contrib_e * wmis_e[:, None], 0.0)
                        record(("env0", t), good, contrib_e, wmis_e)
                    # the camera subpath alone: vertex t-1 is emissive
                    ok = cpath.valid[c1] & (cpath.light_id[c1] >= 0) \
                        & (cpath.vtype[c1] == VTX_SURFACE)
                    wo = vm.normalize(cpath.p[c2] - cpath.p[c1])
                    contrib = cpath.beta[c1] * lightsmod.area_light_radiance(
                        lights, cpath.light_id[c1], cpath.ng[c1], wo)
                    lid = torch.clamp(cpath.light_id[c1], min=0)
                    pdf_origin = power_dist.discrete_pdf(lid) \
                        / torch.clamp(lights.total_area[lid], min=f32(1e-12))
                    pdf_le_dir = vm.absdot(cpath.ng[c1], wo) / PI    # cosine emission
                    ptm_rev = _conv_to_vertex(pdf_le_dir, cpath.p[c1], cpath, c2)
                    wmis = _mis_weight(cpath, lpath, 0, t,
                                       dict(pt_rev=pdf_origin, ptm_rev=ptm_rev))
                    good = ok & (luminance(contrib) > 0)
                    L = L + torch.where(good[:, None], contrib * wmis[:, None], 0.0)
                    record((0, t), good, contrib, wmis)
                elif s == 1:
                    # a light point sampled from camera vertex t-1 (a surface or
                    # medium vertex; escape vertices end s=0 paths only)
                    med_c1 = cpath.vtype[c1] == VTX_MEDIUM
                    ok = cpath.valid[c1] & ~cpath.delta[c1] \
                        & ((cpath.vtype[c1] == VTX_SURFACE) | med_c1)
                    # chosen by power, as the light subpaths are: every strategy
                    # agrees about the others' selection pmf
                    lt, pmf, _ = power_dist.sample_discrete(s1(60 + 8 * (s + 10 * t)))
                    ls = lightsmod.sample_li(lights, scene, lt, cpath.p[c1],
                                             s2(61 + 8 * (s + 10 * t)), scene.world_radius)
                    wo = vm.normalize(cpath.p[c2] - cpath.p[c1])
                    f_c = _vertex_f(scene, cpath, c1, wo, ls["wi"])
                    cos_c1 = torch.where(med_c1, 1.0, vm.absdot(ls["wi"], cpath.ns[c1]))
                    contrib = cpath.beta[c1] * f_c * ls["li"] \
                        * (cos_c1 / torch.clamp(ls["pdf"] * pmf, min=f32(1e-12)))[:, None]
                    if scene.media is not None:
                        contrib = contrib * medmod.medium_tr(
                            scene.media, torch.zeros_like(pid), cpath.p[c1], ls["wi"],
                            ls["dist"], hash_combine(pid, sid, 800 + 8 * t))
                    carry = rays.add(ok & (ls["pdf"] > 0) & (luminance(contrib) > 0))
                    occ = scenemod.occluded(
                        scene, vm.offset_ray_origin(cpath.p[c1], cpath.ng[c1], ls["wi"]),
                        ls["wi"], t_max=torch.clamp(ls["dist"] * SHADOW_SCALE, min=f32(1e-4)),
                        active=carry)
                    # MIS: the sampled light point as the light subpath's vertex 0
                    kind = lights.kind[lt]
                    is_area = (kind == lightsmod.LIGHT_AREA_TRI) \
                        | (kind == lightsmod.LIGHT_AREA_SPHERE)
                    ng_l = ls["ng_l"]
                    cos_l = vm.absdot(ls["wi"], torch.where(is_area[:, None], ng_l, ls["wi"]))
                    pdf_le_dir = torch.clamp(cos_l, min=f32(1e-6)) / PI
                    qs_rev = convert_density(
                        _vertex_pdf(scene, cpath, c1, cpath.p[c2], ls["p_light"]),
                        cpath.p[c1], ls["p_light"], ng_l)
                    pt_rev_s1 = _conv_to_vertex(pdf_le_dir, ls["p_light"], cpath, c1)
                    if lights.env_index >= 0:
                        # the infinite light's position density is the world disk's
                        pt_rev_s1 = torch.where(kind == LIGHT_INFINITE,
                                                disk_pdf * vm.absdot(cpath.ng[c1], ls["wi"]),
                                                pt_rev_s1)
                    ptm_rev_s1 = _conv_to_vertex(
                        _vertex_pdf(scene, cpath, c1, ls["p_light"], cpath.p[c2]),
                        cpath.p[c1], cpath, c2)
                    wmis = _mis_weight(cpath, _sampled_light_path(lpath, lights, ls, lt, pmf),
                                       1, t, dict(qs_rev=qs_rev, pt_rev=pt_rev_s1,
                                                  ptm_rev=ptm_rev_s1))
                    good = carry & ~occ
                    L = L + torch.where(good[:, None], contrib * wmis[:, None], 0.0)
                    record((1, t), good, contrib, wmis)
                else:
                    # light vertex s-1 to camera vertex t-1
                    l1, l2 = s - 1, s - 2
                    med_l = lpath.vtype[l1] == VTX_MEDIUM
                    med_c = cpath.vtype[c1] == VTX_MEDIUM
                    ok = cpath.valid[c1] & lpath.valid[l1] & ~cpath.delta[c1] \
                        & ~lpath.delta[l1] & ((cpath.vtype[c1] == VTX_SURFACE) | med_c)
                    wn, d2 = _connection(lpath.p[l1], cpath.p[c1])
                    f_l = _vertex_f(scene, lpath, l1,
                                    vm.normalize(lpath.p[l2] - lpath.p[l1]), wn)
                    f_c = _vertex_f(scene, cpath, c1,
                                    vm.normalize(cpath.p[c2] - cpath.p[c1]), -wn)
                    contrib = lpath.beta[l1] * f_l * f_c * cpath.beta[c1]
                    carry = rays.add(ok & (luminance(contrib) > 0))
                    contrib = contrib * _g_term(
                        scene, lpath.p[l1], lpath.ng[l1], cpath.ng[c1], wn, d2, med_l, med_c,
                        hash_combine(pid, sid, 700 + 8 * (s + 10 * t)), carry)
                    # the endpoints' reverse densities
                    qs_rev = _conv_to_vertex(
                        _vertex_pdf(scene, cpath, c1, cpath.p[c2], lpath.p[l1]),
                        cpath.p[c1], lpath, l1)
                    pt_rev = _conv_to_vertex(
                        _vertex_pdf(scene, lpath, l1, lpath.p[l2], cpath.p[c1]),
                        lpath.p[l1], cpath, c1)
                    qsm_rev = _conv_to_vertex(
                        _vertex_pdf(scene, lpath, l1, cpath.p[c1], lpath.p[l2]),
                        lpath.p[l1], lpath, l2)
                    ptm_rev = _conv_to_vertex(
                        _vertex_pdf(scene, cpath, c1, lpath.p[l1], cpath.p[c2]),
                        cpath.p[c1], cpath, c2)
                    wmis = _mis_weight(cpath, lpath, s, t,
                                       dict(qs_rev=qs_rev, pt_rev=pt_rev, qsm_rev=qsm_rev,
                                            ptm_rev=ptm_rev))
                    good = ok & (luminance(contrib) > 0)
                    L = L + torch.where(good[:, None], contrib * wmis[:, None], 0.0)
                    record((s, t), good, contrib, wmis)

        # t=1: light vertices splatted to the film through a lens point
        for s in range(2, s_max_v + 1):
            if s - 1 > cfg.max_depth:
                continue
            l1, l2 = s - 1, s - 2
            med_l1 = lpath.vtype[l1] == VTX_MEDIUM
            ok = lpath.valid[l1] & ~lpath.delta[l1]
            wi_c, we, pdf_c, p_raster, p_lens = camera_sample_wi(camera, lpath.p[l1],
                                                                 s2(90 + 4 * s))
            wo_l = vm.normalize(lpath.p[l2] - lpath.p[l1])
            f_l = _vertex_f(scene, lpath, l1, wo_l, wi_c)
            # shading-normal correction of importance transport; 1 in media
            ns_corr = vm.absdot(wo_l, lpath.ns[l1]) * vm.absdot(wi_c, lpath.ng[l1]) \
                / torch.clamp(vm.absdot(wo_l, lpath.ng[l1]) * vm.absdot(wi_c, lpath.ns[l1]),
                              min=f32(1e-8))
            ns_corr = torch.where(med_l1, 1.0, ns_corr)
            dist = vm.length(p_lens - lpath.p[l1])
            cos_l1 = torch.where(med_l1, 1.0, vm.absdot(wi_c, lpath.ns[l1]))
            contrib = lpath.beta[l1] * f_l * (we * cos_l1 * ns_corr
                                              / torch.clamp(pdf_c, min=f32(1e-12)))[:, None]
            if scene.media is not None:
                contrib = contrib * medmod.medium_tr(
                    scene.media, torch.zeros_like(pid), lpath.p[l1], wi_c, dist,
                    hash_combine(pid, sid, 900 + 8 * s))
            carry = rays.add(ok & (pdf_c > 0) & (luminance(contrib) > 0))
            occ = scenemod.occluded(
                scene, vm.offset_ray_origin(lpath.p[l1], lpath.ng[l1], wi_c), wi_c,
                t_max=torch.clamp(dist * SHADOW_SCALE, min=f32(1e-4)), active=carry)
            _, cam_pdf_dir = camera_pdf_we(camera, p_lens, -wi_c)
            qs_rev = _conv_to_vertex(torch.clamp(cam_pdf_dir, min=0.0), p_lens, lpath, l1)
            qsm_rev = _conv_to_vertex(_vertex_pdf(scene, lpath, l1, p_lens, lpath.p[l2]),
                                      lpath.p[l1], lpath, l2)
            wmis = _mis_weight(cpath, lpath, s, 1, dict(qs_rev=qs_rev, qsm_rev=qsm_rev))
            good = carry & ~occ
            splat = filmmod.add_splats(splat, p_raster,
                                       torch.where(good[:, None], contrib * wmis[:, None], 0.0),
                                       enabled=good)
            record((s, 1), good, contrib, wmis)
        img_acc = img_acc + L
        splat_acc = splat_acc + splat

    img = filmmod.resolve(img_acc.reshape(h, w, 3), torch.full((h, w), float(cfg.spp), **f3),
                          splat_acc, 1.0 / cfg.spp)
    out = (img,)
    if debug_strategies:
        denom = 3.0 * hw * cfg.spp       # a mean over pixels and channels
        out += ({k: (float(v[0]) / denom, float(v[1]) / denom) for k, v in strat_acc.items()},)
    if return_stats:
        out += ({"rays_traced": rays.n},)
    return out[0] if len(out) == 1 else out


def _sampled_light_path(lpath, lights, ls, lt, pmf):
    """lpath with a light point sampled by sample_li in its vertex 0 (the
    s=1 strategy's MIS). Its pdf_fwd is the area density of choosing the
    point: pmf / area for area lights, the pmf alone for delta lights, the
    directional density for the infinite light."""
    kind = lights.kind[lt]
    is_area = (kind == lightsmod.LIGHT_AREA_TRI) | (kind == lightsmod.LIGHT_AREA_SPHERE)
    pdf_origin = torch.where(is_area, pmf / torch.clamp(lights.total_area[lt], min=f32(1e-12)),
                             pmf)
    if lights.env_index >= 0:
        pdf_origin = torch.where(kind == LIGHT_INFINITE,
                                 pmf * lightsmod.env_pdf_li(lights, ls["wi"]), pdf_origin)
    return _set_vertex(lpath, 0, p=ls["p_light"], ng=ls["ng_l"], ns=ls["ng_l"],
                       pdf_fwd=pdf_origin, delta=ls["is_delta"], light_id=lt,
                       valid=torch.ones_like(ls["is_delta"]))
