"""Participating media: homogeneous and density-grid media, the
Henyey–Greenstein phase function (counterpart of pbrt_tpu/shade/media.py).

A MediumTable is global to the scene. Lanes carry a medium id (-1 =
vacuum); `medium_tr`, `medium_sample` and `phase_g` dispatch per lane over
the kinds present (a static tuple, so a fog scene never runs grid code).
The grid medium's ratio tracking (`grid_tr`) and delta tracking
(`grid_sample`) step at most MAX_TRACK_STEPS times, as the reference's
fori_loop does, and stop once no lane is alive: checked every CHECK_EVERY
steps, one host sync each. The early stop is exact, since a dead lane's
results no longer change.

Each call of `medium_sample`, `medium_tr` and the phase function
(`phase_g`, `hg_phase`, `hg_sample`) is a span of the `media` layer:
`media.sample`, `media.tr`, `media.phase`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..core import vecmath as vm
from ..core.rng import uniform_float
from ..core.types import INV_4PI, PI, f32

MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1

MAX_TRACK_STEPS = 256
CHECK_EVERY = 8          # tracking steps between host checks for live lanes


@dataclass
class TrackCount:
    """Tracking loops entered and steps run, process-wide; readers take
    the difference of two reads."""
    calls: int = 0
    steps: int = 0


TRACKED = TrackCount()


@dataclass
class MediumTable:
    kind: torch.Tensor             # (M,) int64
    sigma_a: torch.Tensor          # (M, 3)
    sigma_s: torch.Tensor          # (M, 3)
    g: torch.Tensor                # (M,)
    grid: torch.Tensor             # (Nz, Ny, Nx) density of the one grid
    grid_slot: torch.Tensor        # (M,) int64, 0 where the medium uses `grid`
    world_to_medium: torch.Tensor  # (M, 4, 4)
    sigma_scale: torch.Tensor      # (M,) grid density scale
    kinds_present: tuple = ()

    @property
    def count(self):
        return self.kind.shape[0]


COLUMNS = ("kind", "sigma_a", "sigma_s", "g", "grid", "grid_slot", "world_to_medium",
           "sigma_scale")


def media_from_numpy(arrs, device):
    """MediumTable from the JAX package's MediumTable fields as numpy
    arrays (COLUMNS); None for a scene without media."""
    if arrs is None:
        return None
    missing = [k for k in COLUMNS if k not in arrs]
    if missing:
        raise NotImplementedError(f"the medium table does not state {missing}")
    kind = np.asarray(arrs["kind"], np.int64)
    t = lambda k, dt=torch.float32: torch.as_tensor(np.array(arrs[k]), device=device).to(dt)  # noqa: E731
    return MediumTable(kind=t("kind", torch.int64), sigma_a=t("sigma_a"),
                       sigma_s=t("sigma_s"), g=t("g"), grid=t("grid"),
                       grid_slot=t("grid_slot", torch.int64),
                       world_to_medium=t("world_to_medium"), sigma_scale=t("sigma_scale"),
                       kinds_present=tuple(sorted(set(kind.tolist()))))


def build_media(rows, grid=None, device=None):
    """rows: dicts (kind, sigma_a, sigma_s, g, world_to_medium?, scale?),
    as the JAX package's build_media takes them."""
    m = len(rows)

    def col(key, default, shape=()):
        out = np.zeros((m,) + shape, np.float32)
        for i, r in enumerate(rows):
            v = r.get(key, default)
            out[i] = np.broadcast_to(np.asarray(v, np.float32), shape) if shape else v
        return out

    w2m = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    for i, r in enumerate(rows):
        if "world_to_medium" in r:
            w2m[i] = np.asarray(r["world_to_medium"], np.float32)
    return media_from_numpy(dict(
        kind=[int(r["kind"]) for r in rows], sigma_a=col("sigma_a", 0.1, (3,)),
        sigma_s=col("sigma_s", 0.5, (3,)), g=col("g", 0.0),
        grid=np.ones((1, 1, 1), np.float32) if grid is None else np.asarray(grid, np.float32),
        grid_slot=np.zeros(m, np.int64), world_to_medium=w2m,
        sigma_scale=col("scale", 1.0)), device)


# ------------------------------------------------------------ phase function

@trace.spanned("media.phase")
def hg_phase(cos_theta, g):
    """Henyey–Greenstein phase function value."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / torch.clamp(
        denom * torch.sqrt(torch.clamp(denom, min=f32(1e-8))), min=f32(1e-8))


@trace.spanned("media.phase")
def hg_sample(wo, g, u2):
    """Sample wi from HG about wo, the direction back along the ray (PBRT's
    HenyeyGreenstein::Sample_p): wi's density is hg_phase(wo . wi, g), so
    for g > 0 it leans away from wo. Returns (wi, pdf)."""
    small = g.abs() < f32(1e-3)
    g_safe = torch.where(small, f32(1e-3) * torch.sign(g + f32(1e-9)), g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u2[..., 0])
    cos_theta_g = -(1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    cos_theta = torch.where(small, 1.0 - 2.0 * u2[..., 0], cos_theta_g)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u2[..., 1]
    v1, v2 = vm.coordinate_system(wo)
    wi = vm.spherical_direction_in_frame(sin_theta, cos_theta, phi, v1, v2, wo)
    return wi, hg_phase(cos_theta, g)


# ------------------------------------------------------- homogeneous medium

def _avg(s):
    """Mean over the three channels, summed in order."""
    return (s[..., 0] + s[..., 1] + s[..., 2]) / 3.0


def homogeneous_tr(sigma_t, dist):
    """Beer–Lambert transmittance over a segment of length dist."""
    return torch.exp(-sigma_t * torch.clamp(dist, max=f32(1e30))[..., None])


def homogeneous_sample(sigma_t, sigma_s, dist, u, channel_u):
    """A medium interaction along a segment, sampled on a uniformly chosen
    channel. Returns (sampled, t, weight (..., 3)): weight is the
    throughput update, σ_s·Tr / pdf at a medium event, Tr / pdf at the
    surface."""
    nch = sigma_t.shape[-1]
    ch = torch.clamp((channel_u * nch).to(torch.int64), max=nch - 1)
    sig_c = torch.gather(sigma_t, -1, ch[..., None])[..., 0]
    t = -torch.log(torch.clamp(1.0 - u, min=f32(1e-10))) / torch.clamp(sig_c, min=f32(1e-10))
    sampled = t < dist
    t_clamped = torch.minimum(t, dist)
    tr = torch.exp(-sigma_t * t_clamped[..., None])
    pdf_med = torch.clamp(_avg(sigma_t * tr), min=f32(1e-20))
    pdf_surf = torch.clamp(_avg(tr), min=f32(1e-20))
    w_med = tr * sigma_s / pdf_med[..., None]
    w_surf = tr / pdf_surf[..., None]
    return sampled, t_clamped, torch.where(sampled[..., None], w_med, w_surf)


# -------------------------------------------------- per-lane medium dispatch

@trace.spanned("media.tr")
def medium_tr(media: MediumTable, med, o, d, dist, key):
    """Transmittance (N, 3) along [0, dist) of rays starting in medium
    `med` (N,); 1 where med < 0 (vacuum)."""
    if media is None:
        return torch.ones_like(o)
    midc = torch.clamp(med, min=0)
    kind = media.kind[midc]
    tr = torch.ones_like(o)
    if MEDIUM_HOMOGENEOUS in media.kinds_present:
        tr_h = homogeneous_tr(media.sigma_a[midc] + media.sigma_s[midc], dist)
        tr = torch.where((kind == MEDIUM_HOMOGENEOUS)[..., None], tr_h, tr)
    if MEDIUM_GRID in media.kinds_present:
        tr = torch.where((kind == MEDIUM_GRID)[..., None],
                         grid_tr(media, midc, o, d, dist, key), tr)
    return torch.where((med >= 0)[..., None], tr, 1.0)


@trace.spanned("media.sample")
def medium_sample(media: MediumTable, med, o, d, dist, u, u_ch, key):
    """A medium interaction along [0, dist) in medium `med`. Returns
    (sampled, t, weight (N, 3)); vacuum lanes: not sampled, t = dist,
    weight 1."""
    n = o.shape[:-1]
    dist = torch.broadcast_to(dist, n)
    if media is None:
        return torch.zeros(n, dtype=torch.bool, device=o.device), dist, torch.ones_like(o)
    midc = torch.clamp(med, min=0)
    kind = media.kind[midc]
    sampled = torch.zeros(n, dtype=torch.bool, device=o.device)
    t = dist
    weight = torch.ones_like(o)
    if MEDIUM_HOMOGENEOUS in media.kinds_present:
        s_h, t_h, w_h = homogeneous_sample(media.sigma_a[midc] + media.sigma_s[midc],
                                           media.sigma_s[midc], dist, u, u_ch)
        m = kind == MEDIUM_HOMOGENEOUS
        sampled = torch.where(m, s_h, sampled)
        t = torch.where(m, t_h, t)
        weight = torch.where(m[..., None], w_h, weight)
    if MEDIUM_GRID in media.kinds_present:
        s_g, t_g, w_g = grid_sample(media, midc, o, d, dist, key)
        m = kind == MEDIUM_GRID
        sampled = torch.where(m, s_g, sampled)
        t = torch.where(m, t_g, t)
        weight = torch.where(m[..., None], w_g, weight)
    vac = med < 0
    return sampled & ~vac, torch.where(vac, dist, t), torch.where(vac[..., None], 1.0, weight)


@trace.spanned("media.phase")
def phase_g(media: MediumTable, med):
    """Per-lane HG asymmetry (0 for vacuum lanes)."""
    if media is None:
        return torch.zeros(med.shape, dtype=torch.float32, device=med.device)
    return torch.where(med >= 0, media.g[torch.clamp(med, min=0)], 0.0)


# -------------------------------------------------------------- grid medium

def _grid_lookup(media: MediumTable, w2m, p_world):
    """Trilinear density in medium space [0, 1]^3; w2m (N, 4, 4) gathered."""
    pm = (w2m[..., :3, :3] * p_world[..., None, :]).sum(-1) + w2m[..., :3, 3]
    nz, ny, nx = media.grid.shape
    g = pm * torch.tensor([nx, ny, nz], dtype=torch.float32, device=pm.device) - 0.5
    gi = torch.floor(g)
    gf = g - gi
    gi = gi.to(torch.int64)
    flat = media.grid.reshape(-1)

    def axis(i, size):
        """Clamped index and in-range mask of cell i and i + 1."""
        return [(torch.clamp(j, 0, size - 1), (j >= 0) & (j < size)) for j in (i, i + 1)]

    xs, ys, zs = axis(gi[..., 0], nx), axis(gi[..., 1], ny), axis(gi[..., 2], nz)

    def d(a, b, c):
        (x, okx), (y, oky), (z, okz) = xs[a], ys[b], zs[c]
        return torch.where(okx & oky & okz, flat[(z * ny + y) * nx + x], 0.0)

    fx, fy, fz = gf[..., 0], gf[..., 1], gf[..., 2]
    d00 = (1 - fx) * d(0, 0, 0) + fx * d(1, 0, 0)
    d10 = (1 - fx) * d(0, 1, 0) + fx * d(1, 1, 0)
    d01 = (1 - fx) * d(0, 0, 1) + fx * d(1, 0, 1)
    d11 = (1 - fx) * d(0, 1, 1) + fx * d(1, 1, 1)
    return (1 - fz) * ((1 - fy) * d00 + fy * d10) + fz * ((1 - fy) * d01 + fy * d11)


def grid_density(media: MediumTable, mid, p_world):
    """Trilinear density lookup of medium `mid` (N,) at world points (N, 3)."""
    return _grid_lookup(media, media.world_to_medium[mid], p_world)


def _track(step, carry, alive_of):
    """Run step(i, carry) for i < MAX_TRACK_STEPS, stopping once no lane is
    alive (checked every CHECK_EVERY steps). Counts the steps in TRACKED."""
    TRACKED.calls += 1
    for i in range(MAX_TRACK_STEPS):
        if i and i % CHECK_EVERY == 0 and not bool(alive_of(carry).any()):
            break
        carry = step(i, carry)
        TRACKED.steps += 1
    return carry


def grid_tr(media: MediumTable, mid, o, d, dist, key):
    """Ratio-tracking transmittance (N, 3) of medium `mid` over [0, dist)."""
    w2m = media.world_to_medium[mid]
    scale = media.sigma_scale[mid]
    sigma_t = _avg(media.sigma_a[mid] + media.sigma_s[mid]) * scale
    sig = torch.clamp(sigma_t, min=f32(1e-10))
    inv_max = 1.0 / sig

    def step(i, carry):
        tr, t, alive = carry
        u1 = uniform_float(key, 2 * i)
        t = t - torch.log(torch.clamp(1.0 - u1, min=f32(1e-10))) * inv_max
        inside = t < dist
        dens = _grid_lookup(media, w2m, o + t[..., None] * d) * scale
        ratio = 1.0 - dens / sig
        tr = torch.where(alive & inside, tr * torch.clamp(ratio, 0.0, 1.0), tr)
        return tr, t, alive & inside & (tr > f32(1e-4))

    n = o.shape[:-1]
    tr, _, _ = _track(step, (torch.ones(n, dtype=torch.float32, device=o.device),
                             torch.zeros(n, dtype=torch.float32, device=o.device),
                             torch.ones(n, dtype=torch.bool, device=o.device)),
                      lambda c: c[2])
    return tr[..., None].expand(*n, 3).contiguous()


def grid_sample(media: MediumTable, mid, o, d, dist, key):
    """Delta-tracking distance sampling in medium `mid`. Returns (sampled,
    t, weight) as homogeneous_sample does: the albedo at a medium event, 1
    at the surface (null collisions cancel)."""
    sigma_a, sigma_s = media.sigma_a[mid], media.sigma_s[mid]
    w2m = media.world_to_medium[mid]
    scale = media.sigma_scale[mid]
    sigma_t = _avg(sigma_a + sigma_s) * scale
    sig = torch.clamp(sigma_t, min=f32(1e-10))
    inv_max = 1.0 / sig

    def step(i, carry):
        t, sampled, alive = carry
        u1 = uniform_float(key, 2 * i)
        u2 = uniform_float(key, 2 * i + 1)
        t_new = t - torch.log(torch.clamp(1.0 - u1, min=f32(1e-10))) * inv_max
        inside = t_new < dist
        dens = _grid_lookup(media, w2m, o + t_new[..., None] * d) * scale
        real = u2 < dens / sig
        moved = alive & inside
        return (torch.where(moved, t_new, t), sampled | (moved & real), moved & ~real)

    n = o.shape[:-1]
    t, sampled, _ = _track(step, (torch.zeros(n, dtype=torch.float32, device=o.device),
                                  torch.zeros(n, dtype=torch.bool, device=o.device),
                                  torch.ones(n, dtype=torch.bool, device=o.device)),
                           lambda c: c[2])
    albedo = sigma_s / torch.clamp(sigma_a + sigma_s, min=f32(1e-10))
    weight = torch.where(sampled[..., None], albedo, torch.ones_like(albedo))
    return sampled, torch.minimum(t, dist), weight
