"""Light table for triangle area lights (counterpart of LIGHT_AREA_TRI
and the env_radiance query in pbrt_tpu/lights/lights.py)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.types import f32

LIGHT_AREA_TRI = 3
PORTED_KINDS = (LIGHT_AREA_TRI,)


@dataclass
class LightTable:
    kind: torch.Tensor         # (L,) int64
    emit: torch.Tensor         # (L, 3) radiance
    two_sided: torch.Tensor    # (L,) bool
    total_area: torch.Tensor   # (L,)
    em_tri_cdf: torch.Tensor   # (L, ME+1) area CDF over the light's triangles
    em_tri_p: torch.Tensor     # (L, ME, 9) corner positions

    @property
    def count(self):
        return self.kind.shape[0]


def lights_from_numpy(arrs, device):
    """LightTable from numpy columns kind, emit, two_sided, total_area,
    em_tri_cdf, em_tri_p (the JAX package's LightTable layout)."""
    kind = np.asarray(arrs["kind"], np.int64)
    bad = sorted(set(kind.tolist()) - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(f"light kinds {bad} are not ported yet")
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    return LightTable(kind=t(kind, torch.int64), emit=t(arrs["emit"]),
                      two_sided=t(arrs["two_sided"], torch.bool),
                      total_area=t(arrs["total_area"]), em_tri_cdf=t(arrs["em_tri_cdf"]),
                      em_tri_p=t(arrs["em_tri_p"]))


def build_area_lights(rows, positions, indices, device):
    """rows: [dict(tri_ids, L, two_sided)] area lights over scene triangles."""
    pos = np.asarray(positions, np.float32)
    idx = np.asarray(indices).reshape(-1, 3)
    n = len(rows)
    me = max(len(r["tri_ids"]) for r in rows)
    emit = np.zeros((n, 3), np.float32)
    two_sided = np.zeros(n, bool)
    total_area = np.zeros(n, np.float32)
    cdf_t = np.zeros((n, me + 1), np.float32)
    em_p = np.zeros((n, me, 9), np.float32)
    for i, r in enumerate(rows):
        ids = np.asarray(r["tri_ids"], np.int64)
        v0, v1, v2 = (pos[idx[ids, c]] for c in range(3))
        areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
        em_p[i, :len(ids)] = np.concatenate([v0, v1, v2], axis=1)
        total_area[i] = areas.sum()
        cdf = np.concatenate([[0.0], np.cumsum(areas)]) / max(areas.sum(), 1e-12)
        cdf_t[i, :len(ids) + 1] = cdf
        cdf_t[i, len(ids) + 1:] = 1.0
        emit[i] = np.broadcast_to(np.asarray(r["L"], np.float32), (3,))
        two_sided[i] = bool(r.get("two_sided", False))
    return lights_from_numpy(dict(kind=[LIGHT_AREA_TRI] * n, emit=emit,
                                  two_sided=two_sided, total_area=total_area,
                                  em_tri_cdf=cdf_t, em_tri_p=em_p), device)


def _sample_corner_tri(corners, u0, u1):
    p0, p1, p2 = corners[..., 0:3], corners[..., 3:6], corners[..., 6:9]
    su0 = torch.sqrt(torch.clamp(u0, min=0.0))
    b0 = 1.0 - su0
    b1 = u1 * su0
    pnt = b0[..., None] * p0 + b1[..., None] * p1 + (1.0 - b0 - b1)[..., None] * p2
    return pnt, vm.normalize(vm.cross(p1 - p0, p2 - p0))


def sample_li(lights: LightTable, lt, p_ref, u2):
    """Sample a direction toward light `lt` (N,) from p_ref (N, 3).
    Returns dict(wi, li, pdf, p_light, dist, is_delta, ng_l); pdf is per
    solid angle at p_ref."""
    cdf = lights.em_tri_cdf[lt]
    u0 = u2[..., 0]
    slot = torch.clamp((cdf <= u0[..., None]).to(torch.int64).sum(-1) - 1,
                       0, lights.em_tri_p.shape[1] - 1)
    c0 = torch.gather(cdf, -1, slot[..., None])[..., 0]
    c1 = torch.gather(cdf, -1, slot[..., None] + 1)[..., 0]
    u0r = (u0 - c0) / torch.clamp(c1 - c0, min=f32(1e-9))
    corners = lights.em_tri_p[lt, slot]
    pl, ng_l = _sample_corner_tri(corners, u0r, u2[..., 1])
    to_l = pl - p_ref
    d2 = torch.clamp(vm.length_squared(to_l), min=f32(1e-12))
    d = torch.sqrt(d2)
    wi = to_l / d[..., None]
    cos_l = vm.dot(ng_l, -wi)
    emit_ok = lights.two_sided[lt] | (cos_l > 0.0)
    li = torch.where(emit_ok[..., None], lights.emit[lt], 0.0)
    pdf_area = 1.0 / torch.clamp(lights.total_area[lt], min=f32(1e-12))
    pdf = pdf_area * d2 / torch.clamp(cos_l.abs(), min=f32(1e-8))
    pdf = torch.where(cos_l.abs() < f32(1e-7), 0.0, pdf)
    return dict(wi=wi, li=li, pdf=pdf, p_light=pl, dist=d,
                is_delta=torch.zeros_like(emit_ok), ng_l=ng_l)


def area_light_radiance(lights: LightTable, light_id, ng, w):
    """Radiance leaving an area-light point with normal ng toward w."""
    lid = torch.clamp(light_id, min=0)
    ok = (light_id >= 0) & (lights.two_sided[lid] | (vm.dot(ng, w) > 0.0))
    return torch.where(ok[..., None], lights.emit[lid], 0.0)


def pdf_li_area_scene(lights: LightTable, light_id, p_ref, p_hit, ng_hit):
    """Solid-angle pdf that sample_li on `light_id` gives the direction
    from p_ref to the surface point (p_hit, ng_hit)."""
    lid = torch.clamp(light_id, min=0)
    to_l = p_hit - p_ref
    d2 = torch.clamp(vm.length_squared(to_l), min=f32(1e-12))
    wi = to_l / torch.sqrt(d2)[..., None]
    cos_l = vm.dot(ng_hit, -wi).abs()
    pdf = d2 / (torch.clamp(cos_l, min=f32(1e-8))
                * torch.clamp(lights.total_area[lid], min=f32(1e-12)))
    return torch.where(cos_l < f32(1e-7), 0.0, pdf)


def env_radiance(lights: LightTable, d):
    """Radiance of the infinite light for escaped rays. Infinite lights
    are not ported yet (lights_from_numpy refuses them), so escaped rays
    carry none."""
    return torch.zeros_like(d)
