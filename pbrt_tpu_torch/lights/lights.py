"""Light table: sampling, pdfs and emitted radiance for all eight light
kinds (counterpart of pbrt_tpu/lights/lights.py). One SoA table holds
every light; `sample_li` evaluates only the kinds the table holds
(`kinds_present`, a static tuple built on the host), each under a lane
mask. Area lights are triangle ranges (a padded per-light area CDF) or
spheres (cone sampling); the infinite light is a lat-long image with a
luminance·sinθ Distribution2D."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import sampling
from ..core import vecmath as vm
from ..core.sampling import Distribution1D, Distribution2D
from ..core.spectrum import luminance
from ..core.types import INV_2PI, INV_4PI, INV_PI, PI, f32, safe_sqrt
from ..diff.rows import rows
from ..geom import quadrics as quadmod

LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA_TRI = 3
LIGHT_AREA_SPHERE = 4
LIGHT_INFINITE = 5
LIGHT_GONIO = 6
LIGHT_PROJECTION = 7

_POSITIONAL = (LIGHT_POINT, LIGHT_SPOT, LIGHT_GONIO, LIGHT_PROJECTION)
# columns of the table as lights_from_numpy takes them: (name, dtype)
COLUMNS = (("kind", torch.int64), ("p", None), ("direction", None), ("tangent", None),
           ("bitangent", None), ("emit", None), ("cos_start", None), ("cos_end", None),
           ("prim_start", torch.int64), ("prim_count", torch.int64),
           ("two_sided", torch.bool), ("total_area", None), ("em_tri_idx", torch.int64),
           ("em_tri_cdf", None), ("em_tri_p", None), ("env_image", None),
           ("env_to_world", None), ("world_to_env", None), ("gonio_image", None))
ENV_DIST = ("conditional_func", "conditional_cdf", "conditional_func_int",
            "marginal_func", "marginal_cdf", "marginal_func_int")


@dataclass
class LightTable:
    kind: torch.Tensor          # (L,) int64
    p: torch.Tensor             # (L, 3) position
    direction: torch.Tensor     # (L, 3) spot / distant / projection axis (unit)
    tangent: torch.Tensor       # (L, 3) image-plane x axis (projection)
    bitangent: torch.Tensor     # (L, 3) image-plane y axis
    emit: torch.Tensor          # (L, 3) intensity (delta) or radiance (area, infinite)
    cos_start: torch.Tensor     # (L,) spot falloff start
    cos_end: torch.Tensor       # (L,) spot width / projection half-fov cosine
    prim_start: torch.Tensor    # (L,) the sphere light's quadric id
    prim_count: torch.Tensor    # (L,) emissive triangles
    two_sided: torch.Tensor     # (L,) bool
    total_area: torch.Tensor    # (L,)
    em_tri_idx: torch.Tensor    # (L, ME) scene triangle ids (pad -1)
    em_tri_cdf: torch.Tensor    # (L, ME+1) area CDF over the light's triangles
    em_tri_p: torch.Tensor      # (L, ME, 9) corner positions
    env_image: torch.Tensor     # (He, We, 3)
    env_dist: Distribution2D    # luminance·sinθ over the env image
    env_to_world: torch.Tensor  # (3, 3)
    world_to_env: torch.Tensor  # (3, 3)
    gonio_image: torch.Tensor   # (Hg, Wg, 3) goniometric / projection image
    kinds_present: tuple = ()
    env_index: int = -1

    @property
    def count(self):
        return self.kind.shape[0]


def lights_from_numpy(arrs, device):
    """LightTable from numpy columns laid out as the JAX package's
    LightTable: the COLUMNS, env_dist's six arrays under ENV_DIST, and
    env_index; kinds_present is taken from `kind`."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(  # noqa: E731
        torch.float32 if dt is None else dt)
    cols = {k: t(arrs[k], dt) for k, dt in COLUMNS}
    d = {k: t(arrs[k], None) for k in ENV_DIST}
    env_dist = Distribution2D(
        Distribution1D(d["conditional_func"], d["conditional_cdf"], d["conditional_func_int"]),
        Distribution1D(d["marginal_func"], d["marginal_cdf"], d["marginal_func_int"]))
    kind = np.asarray(arrs["kind"], np.int64)
    return LightTable(**cols, env_dist=env_dist,
                      kinds_present=tuple(sorted(set(kind.tolist()))),
                      env_index=int(arrs["env_index"]))


def build_lights(rows, positions=None, indices=None, quad_params=None, env_image=None,
                 env_to_world=None, gonio_image=None, device=None):
    """The table from light rows, on the host as the JAX package's
    build_lights. Keys per kind:
      point: p, I | spot: p, direction, I, cone_deg, falloff_deg
      distant: direction (toward the light), L
      area_tri: tri_ids (scene triangle ids) or tris (T, 9) world-space
        corner rows (an emissive instance's), L, two_sided
      area_sphere: quadric_id, L, two_sided
      infinite: L (scale of env_image) | gonio: p, I | projection: p,
      direction, I, fov_deg (both read gonio_image)."""
    n = len(rows)
    me = max([len(np.asarray(r["tris"]).reshape(-1, 9)) if "tris" in r
              else len(r.get("tri_ids", [])) for r in rows] + [1])
    kind = np.zeros(n, np.int32)
    p = np.zeros((n, 3), np.float32)
    direction = np.tile(np.array([0, 0, 1], np.float32), (n, 1))
    tangent = np.tile(np.array([1, 0, 0], np.float32), (n, 1))
    bitangent = np.tile(np.array([0, 1, 0], np.float32), (n, 1))
    emit = np.zeros((n, 3), np.float32)
    cos_start = np.ones(n, np.float32)
    cos_end = np.ones(n, np.float32)
    prim_start = np.zeros(n, np.int32)
    prim_count = np.zeros(n, np.int32)
    two_sided = np.zeros(n, bool)
    total_area = np.zeros(n, np.float32)
    em_tri_idx = np.full((n, me), -1, np.int32)
    em_tri_cdf = np.zeros((n, me + 1), np.float32)
    em_tri_p = np.zeros((n, me, 9), np.float32)
    env_index = -1
    for i, r in enumerate(rows):
        k = r["kind"]
        kind[i] = k
        p[i] = np.asarray(r.get("p", (0, 0, 0)), np.float32)
        if "direction" in r:
            dv = np.asarray(r["direction"], np.float32)
            direction[i] = dv / max(np.linalg.norm(dv), 1e-12)
        # image frame from the light's axis: the row's `up`, else +y
        # (+x when the axis is near ±y)
        up = np.asarray(r.get("up", (0.0, 1.0, 0.0)), np.float32)
        if abs(float(np.dot(up, direction[i]))) > 0.999:
            up = np.array([1.0, 0.0, 0.0], np.float32)
        t1 = np.cross(up, direction[i])
        t1 = t1 / max(np.linalg.norm(t1), 1e-12)
        tangent[i] = t1
        bitangent[i] = np.cross(direction[i], t1)
        emit[i] = np.broadcast_to(np.asarray(r.get("I", r.get("L", 1.0)), np.float32), (3,))
        if k == LIGHT_SPOT:
            cos_end[i] = np.cos(np.deg2rad(r.get("cone_deg", 30.0)))
            cos_start[i] = np.cos(np.deg2rad(r.get("falloff_deg",
                                                   r.get("cone_deg", 30.0) - 5.0)))
        if k == LIGHT_PROJECTION:
            cos_end[i] = np.cos(np.deg2rad(r.get("fov_deg", 45.0) / 2.0))
        if k == LIGHT_AREA_TRI:
            if "tris" in r:
                # explicit corner rows: an emissive instance's triangles live
                # in its prototype, not the scene's pool (em_tri_idx stays -1)
                corners = np.asarray(r["tris"], np.float32).reshape(-1, 9)
                v0, v1, v2 = corners[:, 0:3], corners[:, 3:6], corners[:, 6:9]
            else:
                pos = np.asarray(positions)
                idx = np.asarray(indices).reshape(-1, 3)
                ids = np.asarray(r["tri_ids"], np.int32)
                em_tri_idx[i, :len(ids)] = ids
                v0, v1, v2 = (pos[idx[ids, c]] for c in range(3))
            nid = len(v0)
            prim_count[i] = nid
            areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
            em_tri_p[i, :nid] = np.concatenate([v0, v1, v2], axis=1)
            total_area[i] = areas.sum()
            cdf = np.concatenate([[0.0], np.cumsum(areas)]) / max(areas.sum(), 1e-12)
            em_tri_cdf[i, :nid + 1] = cdf
            em_tri_cdf[i, nid + 1:] = 1.0
            two_sided[i] = bool(r.get("two_sided", False))
        if k == LIGHT_AREA_SPHERE:
            qid = int(r["quadric_id"])
            prim_start[i] = qid
            radius = float(np.asarray(quad_params)[qid, 0])
            total_area[i] = 4.0 * np.pi * radius * radius
            two_sided[i] = bool(r.get("two_sided", False))
        if k == LIGHT_INFINITE:
            env_index = i
    env_image = np.asarray(np.ones((1, 1, 3)) if env_image is None else env_image, np.float32)
    he = env_image.shape[0]
    lum = luminance(torch.as_tensor(env_image)).numpy()
    sin_theta = np.sin(np.pi * (np.arange(he) + 0.5) / he)[:, None]
    dist = Distribution2D.build(torch.as_tensor(lum * sin_theta + 1e-8))
    env_to_world = np.asarray(np.eye(3) if env_to_world is None else env_to_world, np.float32)
    gonio_image = np.ones((1, 1, 3)) if gonio_image is None else gonio_image
    arrs = dict(kind=kind, p=p, direction=direction, tangent=tangent, bitangent=bitangent,
                emit=emit, cos_start=cos_start, cos_end=cos_end, prim_start=prim_start,
                prim_count=prim_count, two_sided=two_sided, total_area=total_area,
                em_tri_idx=em_tri_idx, em_tri_cdf=em_tri_cdf, em_tri_p=em_tri_p,
                env_image=env_image, env_to_world=env_to_world,
                world_to_env=env_to_world.T, gonio_image=np.asarray(gonio_image, np.float32),
                env_index=env_index)
    for part, d1 in (("conditional", dist.conditional), ("marginal", dist.marginal)):
        arrs[f"{part}_func"] = d1.func.numpy()
        arrs[f"{part}_cdf"] = d1.cdf.numpy()
        arrs[f"{part}_func_int"] = d1.func_int.numpy()
    return lights_from_numpy(arrs, device)


# ------------------------------------------------------------ sampling

def _apply(m, v):
    """(3, 3) matrix m applied to vectors v (..., 3)."""
    return (v[..., None, :] * m).sum(-1)


def _sample_corner_tri(corners, u0, u1):
    """A point uniform by area on packed corner rows (..., 9) → (p, ng)."""
    p0, p1, p2 = corners[..., 0:3], corners[..., 3:6], corners[..., 6:9]
    su0 = torch.sqrt(torch.clamp(u0, min=0.0))
    b0 = 1.0 - su0
    b1 = u1 * su0
    pnt = b0[..., None] * p0 + b1[..., None] * p1 + (1.0 - b0 - b1)[..., None] * p2
    return pnt, vm.normalize(vm.cross(p1 - p0, p2 - p0))


def _uv_of(w):
    """Lat-long (u, v) of unit directions w (phi / 2π, theta / π), and theta."""
    theta = vm.spherical_theta(w)
    return torch.stack([vm.spherical_phi(w) * INV_2PI, theta * INV_PI], -1), theta


def sample_li(lights: LightTable, scene, lt, p_ref, u2, world_radius):
    """Sample a direction toward light `lt` (N,) from p_ref (N, 3).
    Returns dict(wi, li, pdf, p_light, dist, is_delta, ng_l); pdf is per
    solid angle at p_ref, dist the shadow ray's length (2·world_radius
    toward distant and infinite lights), ng_l the light's normal at the
    sample (-wi where it has no surface)."""
    kind = lights.kind[lt]
    emit = rows(lights.emit, lt)
    zero = torch.zeros_like(p_ref[..., 0])
    parts = []      # (mask, wi, li, pdf, p_light, dist, is_delta, ng_l) per kind group

    def put(mask, wi, li, pdf, p_light, dist, delta, ng=None):
        parts.append((mask, wi, li, pdf, p_light, dist, delta, -wi if ng is None else ng))

    kp = lights.kinds_present
    if set(kp) & set(_POSITIONAL):
        lp = lights.p[lt]
        ldir = lights.direction[lt]
        to_l = lp - p_ref
        d2 = torch.clamp(vm.length_squared(to_l), min=f32(1e-12))
        d = torch.sqrt(d2)
        wi = to_l / d[..., None]
        li = emit / d2[..., None]
        if LIGHT_SPOT in kp:
            ct = vm.dot(-wi, ldir)
            cs, ce = lights.cos_start[lt], lights.cos_end[lt]
            delta_t = torch.clamp((ct - ce) / torch.clamp(cs - ce, min=f32(1e-6)), 0.0, 1.0)
            falloff = torch.where(ct < ce, 0.0, torch.where(ct > cs, 1.0, delta_t ** 4))
            li = torch.where((kind == LIGHT_SPOT)[..., None], li * falloff[..., None], li)
        if LIGHT_GONIO in kp:
            g = _latlong_lookup(lights.gonio_image, _apply(lights.world_to_env, -wi))
            li = torch.where((kind == LIGHT_GONIO)[..., None], li * g, li)
        if LIGHT_PROJECTION in kp:
            su, sv, inside = _project_uv(lights, lt, -wi, ldir)
            proj = _image_lookup_clamped(lights.gonio_image, torch.stack([su, sv], -1))
            li = torch.where((kind == LIGHT_PROJECTION)[..., None],
                             li * proj * inside[..., None], li)
        mask = ((kind == LIGHT_POINT) | (kind == LIGHT_SPOT) | (kind == LIGHT_GONIO)
                | (kind == LIGHT_PROJECTION))
        put(mask, wi, li, torch.ones_like(zero), lp, d, torch.ones_like(mask))

    if LIGHT_DISTANT in kp:
        wi = lights.direction[lt]
        far = 2.0 * world_radius
        put(kind == LIGHT_DISTANT, wi, emit, torch.ones_like(zero), p_ref + far * wi,
            torch.full_like(zero, far), torch.ones_like(zero, dtype=torch.bool))

    if LIGHT_AREA_TRI in kp:
        # a triangle by area from the light's padded CDF
        cdf = lights.em_tri_cdf[lt]
        u0 = u2[..., 0]
        slot = torch.clamp((cdf <= u0[..., None]).to(torch.int64).sum(-1) - 1,
                           0, lights.em_tri_p.shape[1] - 1)
        c0 = torch.gather(cdf, -1, slot[..., None])[..., 0]
        c1 = torch.gather(cdf, -1, slot[..., None] + 1)[..., 0]
        u0r = (u0 - c0) / torch.clamp(c1 - c0, min=f32(1e-9))
        pl, ng = _sample_corner_tri(lights.em_tri_p[lt, slot], u0r, u2[..., 1])
        to_l = pl - p_ref
        d2 = torch.clamp(vm.length_squared(to_l), min=f32(1e-12))
        d = torch.sqrt(d2)
        wi = to_l / d[..., None]
        cos_l = vm.dot(ng, -wi)
        li = torch.where((lights.two_sided[lt] | (cos_l > 0.0))[..., None], emit, 0.0)
        pdf_area = 1.0 / torch.clamp(lights.total_area[lt], min=f32(1e-12))
        pdf = pdf_area * d2 / torch.clamp(cos_l.abs(), min=f32(1e-8))
        pdf = torch.where(cos_l.abs() < f32(1e-7), 0.0, pdf)
        put(kind == LIGHT_AREA_TRI, wi, li, pdf, pl, d,
            torch.zeros_like(zero, dtype=torch.bool), ng)

    if LIGHT_AREA_SPHERE in kp:
        pl, ng, pdf = quadmod.sphere_sample(scene.quad, lights.prim_start[lt], p_ref, u2)
        to_l = pl - p_ref
        d = torch.clamp(vm.length(to_l), min=f32(1e-9))
        wi = to_l / d[..., None]
        cos_l = vm.dot(ng, -wi)
        li = torch.where((lights.two_sided[lt] | (cos_l > 0.0))[..., None], emit, 0.0)
        put(kind == LIGHT_AREA_SPHERE, wi, li, pdf, pl, d,
            torch.zeros_like(zero, dtype=torch.bool), ng)

    if LIGHT_INFINITE in kp:
        uv, map_pdf = lights.env_dist.sample_continuous(u2)
        theta = uv[..., 1] * PI
        phi = uv[..., 0] * 2.0 * PI
        st, ct = torch.sin(theta), torch.cos(theta)
        wl = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        wi = _apply(lights.env_to_world, wl)
        pdf = torch.where(st > f32(1e-7),
                          map_pdf / (2.0 * PI * PI * torch.clamp(st, min=f32(1e-7))), 0.0)
        far = 2.0 * world_radius
        put(kind == LIGHT_INFINITE, wi, emit * _env_lookup_uv(lights.env_image, uv), pdf,
            p_ref + far * wi, torch.full_like(zero, far),
            torch.zeros_like(zero, dtype=torch.bool))
    # every light's kind is present, so each lane takes one group's values;
    # a table of one kind group needs no select
    out = list(parts[0][1:])
    for mask, *vals in parts[1:]:
        out = [torch.where(mask[..., None] if v.dim() > mask.dim() else mask, v, o)
               for v, o in zip(vals, out)]
    return dict(zip(("wi", "li", "pdf", "p_light", "dist", "is_delta", "ng_l"), out))


def _bilinear(img, uv, wrap_x):
    """Bilinear lookup at uv, texel centers at half-integers; x wraps
    (lat-long φ) or clamps, y clamps."""
    h, w = img.shape[:2]
    x = uv[..., 0] * w - 0.5
    y = uv[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    if wrap_x:
        xa, xb = torch.remainder(x0, w), torch.remainder(x0 + 1, w)
    else:
        xa, xb = torch.clamp(x0, 0, w - 1), torch.clamp(x0 + 1, 0, w - 1)
    ya, yb = torch.clamp(y0, 0, h - 1), torch.clamp(y0 + 1, 0, h - 1)
    return ((1 - fy) * ((1 - fx) * img[ya, xa] + fx * img[ya, xb])
            + fy * ((1 - fx) * img[yb, xa] + fx * img[yb, xb]))


def _env_lookup_uv(img, uv):
    return _bilinear(img, uv, wrap_x=True)


def _image_lookup_clamped(img, uv):
    return _bilinear(img, uv, wrap_x=False)


def _project_uv(lights: LightTable, lt, dl, ldir):
    """Image-plane (u, v) of the light→point direction dl for a
    projection light, the screen window widened by the image aspect."""
    ct = vm.dot(dl, ldir)
    ce = lights.cos_end[lt]
    tan_half = safe_sqrt(1.0 - ce * ce) / torch.clamp(ce, min=f32(1e-6))
    hgt, wdt = lights.gonio_image.shape[:2]
    aspect = float(wdt) / float(hgt)
    sx, sy = max(aspect, 1.0), max(1.0 / aspect, 1.0)
    x = vm.dot(dl, lights.tangent[lt])
    y = vm.dot(dl, lights.bitangent[lt])
    z = torch.clamp(ct, min=f32(1e-6))
    su = 0.5 + 0.5 * (x / z) / torch.clamp(tan_half * sx, min=f32(1e-6))
    sv = 0.5 + 0.5 * (y / z) / torch.clamp(tan_half * sy, min=f32(1e-6))
    inside = (ct > 0.0) & (su >= 0.0) & (su <= 1.0) & (sv >= 0.0) & (sv <= 1.0)
    return su, sv, inside


def _latlong_lookup(img, w_local):
    return _env_lookup_uv(img, _uv_of(w_local)[0])


def env_radiance(lights: LightTable, d):
    """Radiance of the infinite light along escaped rays d (zero
    without one)."""
    if lights is None or lights.env_index < 0:
        return torch.zeros_like(d)
    wl = _apply(lights.world_to_env, vm.normalize(d))
    return lights.emit[lights.env_index] * _latlong_lookup(lights.env_image, wl)


def env_pdf_li(lights: LightTable, wi):
    """Solid-angle pdf that the infinite light's sample_li gives wi."""
    uv, theta = _uv_of(_apply(lights.world_to_env, vm.normalize(wi)))
    st = torch.sin(theta)
    map_pdf = lights.env_dist.pdf(uv)
    return torch.where(st > f32(1e-7),
                       map_pdf / (2.0 * PI * PI * torch.clamp(st, min=f32(1e-7))), 0.0)


def area_light_radiance(lights: LightTable, light_id, ng, w):
    """Radiance leaving an area-light point with normal ng toward w."""
    lid = torch.clamp(light_id, min=0)
    ok = (light_id >= 0) & (lights.two_sided[lid] | (vm.dot(ng, w) > 0.0))
    return torch.where(ok[..., None], rows(lights.emit, lid), 0.0)


def pdf_li_area_scene(lights: LightTable, scene, light_id, p_ref, p_hit, ng_hit):
    """Solid-angle pdf that sample_li on `light_id` gives the direction
    from p_ref to the surface point (p_hit, ng_hit)."""
    lid = torch.clamp(light_id, min=0)
    to_l = p_hit - p_ref
    d2 = torch.clamp(vm.length_squared(to_l), min=f32(1e-12))
    wi = to_l / torch.sqrt(d2)[..., None]
    cos_l = vm.dot(ng_hit, -wi).abs()
    pdf = d2 / (torch.clamp(cos_l, min=f32(1e-8))
                * torch.clamp(lights.total_area[lid], min=f32(1e-12)))
    pdf = torch.where(cos_l < f32(1e-7), 0.0, pdf)
    if LIGHT_AREA_SPHERE in lights.kinds_present:
        pdf_sph = quadmod.sphere_pdf(scene.quad, lights.prim_start[lid], p_ref, wi)
        pdf = torch.where(lights.kind[lid] == LIGHT_AREA_SPHERE, pdf_sph, pdf)
    return pdf


def sample_le(lights: LightTable, scene, lt, u_pos, u_dir, world_radius):
    """Sample a ray leaving light `lt` (N,): the photon rays of SPPM and
    the first segment of BDPT's light subpaths. Returns dict(o, d, ng_l,
    le, pdf_pos, pdf_dir): pdf_pos per area (1 for the positional
    lights, 1/(π r²) on the world disk for the distant and infinite
    lights), pdf_dir per solid angle."""
    n = lt.shape
    kind = lights.kind[lt]
    lp = lights.p[lt]
    ldir = lights.direction[lt]
    emit = rows(lights.emit, lt)
    f3 = dict(dtype=torch.float32, device=lt.device)
    out = dict(o=torch.zeros(n + (3,), **f3), d=torch.zeros(n + (3,), **f3),
               ng_l=torch.zeros(n + (3,), **f3), le=torch.zeros(n + (3,), **f3),
               pdf_pos=torch.zeros(n, **f3), pdf_dir=torch.zeros(n, **f3))
    ones = torch.ones(n, **f3)

    def put(mask, o, d, ng, le, pp, pd):
        for k, v in zip(("o", "d", "ng_l", "le", "pdf_pos", "pdf_dir"), (o, d, ng, le, pp, pd)):
            out[k] = torch.where(mask[..., None] if out[k].dim() > mask.dim() else mask,
                                 v, out[k])

    def in_frame(w_local, t1, t2, z):
        return w_local[..., 0:1] * t1 + w_local[..., 1:2] * t2 + w_local[..., 2:3] * z

    # the world disk's area density, in float32 as the reference computes it
    disk_pdf = f32(1.0 / f32(f32(PI * world_radius) * world_radius))
    kp = lights.kinds_present
    if LIGHT_POINT in kp:
        d_k = sampling.uniform_sample_sphere(u_dir)
        put(kind == LIGHT_POINT, lp, d_k, d_k, emit, ones, torch.full(n, INV_4PI, **f3))
    if LIGHT_SPOT in kp:
        ce, cs = lights.cos_end[lt], lights.cos_start[lt]
        t1, t2 = vm.coordinate_system(ldir)
        d_k = in_frame(sampling.uniform_sample_cone(u_dir, ce), t1, t2, ldir)
        ct = vm.dot(d_k, ldir)
        delta_t = torch.clamp((ct - ce) / torch.clamp(cs - ce, min=f32(1e-6)), 0.0, 1.0)
        falloff = torch.where(ct < ce, 0.0, torch.where(ct > cs, 1.0, delta_t ** 4))
        put(kind == LIGHT_SPOT, lp, d_k, d_k, emit * falloff[..., None], ones,
            sampling.uniform_cone_pdf(ce))
    if LIGHT_GONIO in kp:
        # uniform-sphere emission modulated by the goniometric image
        d_k = sampling.uniform_sample_sphere(u_dir)
        g = _latlong_lookup(lights.gonio_image, _apply(lights.world_to_env, d_k))
        put(kind == LIGHT_GONIO, lp, d_k, d_k, emit * g, ones, torch.full(n, INV_4PI, **f3))
    if LIGHT_PROJECTION in kp:
        # a uniform cone within the projection's fov, modulated by its image
        ce = lights.cos_end[lt]
        d_k = in_frame(sampling.uniform_sample_cone(u_dir, ce), lights.tangent[lt],
                       lights.bitangent[lt], ldir)
        su, sv, inside = _project_uv(lights, lt, d_k, ldir)
        proj = _image_lookup_clamped(lights.gonio_image, torch.stack([su, sv], -1))
        put(kind == LIGHT_PROJECTION, lp, d_k, d_k, emit * proj * inside[..., None], ones,
            sampling.uniform_cone_pdf(ce))
    if LIGHT_DISTANT in kp:
        # a point on the world disk perpendicular to the direction
        t1, t2 = vm.coordinate_system(ldir)
        cd = sampling.concentric_sample_disk(u_pos)
        o_k = (cd[..., 0:1] * t1 + cd[..., 1:2] * t2) * world_radius + ldir * world_radius
        put(kind == LIGHT_DISTANT, o_k, -ldir, -ldir, emit, torch.full(n, disk_pdf, **f3),
            ones)
    if LIGHT_AREA_TRI in kp:
        # a triangle by area, a point on it, a cosine-distributed direction
        cdf = lights.em_tri_cdf[lt]
        u0 = u_pos[..., 0]
        slot = torch.clamp((cdf <= u0[..., None]).to(torch.int64).sum(-1) - 1,
                           0, lights.em_tri_idx.shape[1] - 1)
        c0 = torch.gather(cdf, -1, slot[..., None])[..., 0]
        c1 = torch.gather(cdf, -1, slot[..., None] + 1)[..., 0]
        u0r = (u0 - c0) / torch.clamp(c1 - c0, min=f32(1e-9))
        pl, ngl = _sample_corner_tri(lights.em_tri_p[lt, slot], u0r, u_pos[..., 1])
        w_local = sampling.cosine_sample_hemisphere(u_dir)
        t1, t2 = vm.coordinate_system(ngl)
        put(kind == LIGHT_AREA_TRI, pl, in_frame(w_local, t1, t2, ngl), ngl, emit,
            1.0 / torch.clamp(lights.total_area[lt], min=f32(1e-12)),
            sampling.cosine_hemisphere_pdf(torch.clamp(w_local[..., 2], min=0.0)))
    if LIGHT_AREA_SPHERE in kp:
        qid = lights.prim_start[lt]
        center = scene.quad.obj_to_world[qid][..., :3, 3]
        radius = scene.quad.params[qid, ..., 0]
        n_sph = sampling.uniform_sample_sphere(u_pos)
        pl = center + radius[..., None] * n_sph
        w_local = sampling.cosine_sample_hemisphere(u_dir)
        t1, t2 = vm.coordinate_system(n_sph)
        put(kind == LIGHT_AREA_SPHERE, pl, in_frame(w_local, t1, t2, n_sph), n_sph, emit,
            1.0 / torch.clamp(lights.total_area[lt], min=f32(1e-12)),
            sampling.cosine_hemisphere_pdf(torch.clamp(w_local[..., 2], min=0.0)))
    if LIGHT_INFINITE in kp:
        # a direction from the env map, the origin on the world disk behind it
        uv, map_pdf = lights.env_dist.sample_continuous(u_dir)
        theta = uv[..., 1] * PI
        phi = uv[..., 0] * 2.0 * PI
        st, ct = torch.sin(theta), torch.cos(theta)
        wl = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
        w_world = -_apply(lights.env_to_world, wl)
        t1, t2 = vm.coordinate_system(-w_world)
        cd = sampling.concentric_sample_disk(u_pos)
        o_k = scene.world_center + world_radius * (cd[..., 0:1] * t1 + cd[..., 1:2] * t2
                                                   - w_world)
        pdf_d = torch.where(st > f32(1e-7),
                            map_pdf / (2.0 * PI * PI * torch.clamp(st, min=f32(1e-7))), 0.0)
        put(kind == LIGHT_INFINITE, o_k, w_world, w_world,
            emit * _env_lookup_uv(lights.env_image, uv), torch.full(n, disk_pdf, **f3), pdf_d)
    return out


def power(lights: LightTable, world_radius):
    """Approximate emitted power of each light (for the power strategy)."""
    area_term = PI * lights.total_area * torch.where(lights.two_sided, 2.0, 1.0)
    disk = PI * world_radius * world_radius
    lum = luminance(lights.emit)
    env_mean = luminance(lights.env_image.mean((0, 1)))
    k = lights.kind
    return torch.where(
        k == LIGHT_POINT, 4.0 * PI * lum,
        torch.where(k == LIGHT_SPOT,
                    2.0 * PI * (1.0 - 0.5 * (lights.cos_start + lights.cos_end)) * lum,
                    torch.where(k == LIGHT_DISTANT, disk * lum,
                                torch.where((k == LIGHT_AREA_TRI) | (k == LIGHT_AREA_SPHERE),
                                            area_term * lum,
                                            torch.where(k == LIGHT_INFINITE,
                                                        disk * lum * env_mean,
                                                        4.0 * PI * lum)))))
