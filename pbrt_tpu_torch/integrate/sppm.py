"""Stochastic progressive photon mapping (counterpart of
pbrt_tpu/integrate/sppm.py). Each iteration:

  * camera pass: one sample a pixel traced through specular surfaces to
    its first diffuse vertex, the visible point (p, wo, β, material),
    with MIS direct lighting at every vertex on the way;
  * photon pass: lights chosen by power emit photons (lights.sample_le)
    that walk the scene with Russian roulette, depositing at every
    surface hit after the first;
  * gathering: the photons within each visible point's radius, by a
    dense (visible point × photon chunk) distance test or by a hash grid
    (photons sorted by the hash of their cell, each visible point
    scanning the 8 cells its ball can touch, at most `max_photons_per_cell`
    photons a cell; the overflow is counted and reported);
  * the per-pixel radius and flux update with α.

Every scene query goes through geom.scene (the tile×cluster kernels on
the card)."""
from __future__ import annotations

import dataclasses
import logging
from typing import NamedTuple

import numpy as np
import torch

from ..cameras import generate_rays_weighted
from ..core import samplers as smp
from ..core import vecmath as vm
from ..core.rng import as_u32, mul32
from ..core.spectrum import luminance
from ..core.types import PI, f32
from ..geom import scene as scenemod
from ..lights import lights as lightsmod
from ..shade import materials as matmod
from . import common

# kinds a visible point is stored at (the diffuse-ish materials)
DIFFUSE_KINDS = (matmod.MAT_MATTE, matmod.MAT_PLASTIC, matmod.MAT_SUBSTRATE,
                 matmod.MAT_TRANSLUCENT, matmod.MAT_UBER)
PHOTON_ID0 = 0x8000_0000     # photon ids start here, apart from the pixels'


class SPPMConfig(NamedTuple):
    width: int = 64
    height: int = 64
    n_iterations: int = 8
    photons_per_iter: int = 8192
    max_depth: int = 5
    initial_radius: float = 0.05
    alpha: float = 0.7
    sampler: smp.SamplerConfig = smp.SamplerConfig(kind="random", spp=1)
    # photon gathering: "dense", "grid" or "auto" (grid above 2^28 pairs)
    gather: str = "auto"
    max_photons_per_cell: int = 32
    return_stats: bool = False   # render() → (img, {"photons_dropped", "rays_traced"})


def _camera_pass(scene, camera, cfg, it):
    """One camera sample a pixel to its first diffuse vertex. Returns
    (ld (HW, 3), vp: dict of per-pixel visible-point tensors, rays)."""
    h, w = cfg.height, cfg.width
    hw = h * w
    dev = scene.device
    pixel_id = torch.arange(hw, dtype=torch.int64, device=dev)
    sample_idx = torch.full((hw,), it, dtype=torch.int64, device=dev)
    scfg = cfg.sampler

    def s1(dim):
        return smp.sample_1d(scfg, pixel_id, sample_idx, dim)

    def s2(dim):
        return smp.sample_2d(scfg, pixel_id, sample_idx, dim)

    u_film = s2(smp.DIM_FILM)
    px = (pixel_id % w).to(torch.float32)
    py = torch.div(pixel_id, w, rounding_mode="floor").to(torch.float32)
    pfilm = torch.stack([px + u_film[..., 0], py + u_film[..., 1]], -1)
    o, d, _, _ = generate_rays_weighted(camera, pfilm, s2(smp.DIM_LENS), s1(smp.DIM_TIME))

    lights = scene.lights
    kinds = scene.materials.kinds_present
    f3 = dict(dtype=torch.float32, device=dev)
    ld = torch.zeros((hw, 3), **f3)
    beta = torch.ones((hw, 3), **f3)
    active = torch.ones((hw,), dtype=torch.bool, device=dev)
    stored = torch.zeros((hw,), dtype=torch.bool, device=dev)
    z3 = torch.zeros((hw, 3), **f3)
    vp = dict(p=z3, wo=z3, ns=z3, ng=z3, dpdu=z3, beta=z3,
              mid=torch.full((hw,), -1, dtype=torch.int64, device=dev),
              uv=torch.zeros((hw, 2), **f3), valid=torch.zeros_like(stored))
    specular_bounce = torch.zeros_like(stored)
    rays = torch.zeros((), **f3)
    for bounce in range(cfg.max_depth):
        rays = rays + active.to(torch.float32).sum()
        hit = scenemod.intersect(scene, o, d, active=active)
        wo = -d
        le = torch.where(hit.valid[..., None],
                         lightsmod.area_light_radiance(lights, hit.light_id, hit.ng, wo),
                         lightsmod.env_radiance(lights, d))
        count_emit = active & specular_bounce if bounce else active
        ld = ld + torch.where(count_emit[..., None], beta * le, 0.0)
        active = active & hit.valid & (hit.material_id >= 0)

        frame = common.shading_frame(hit)
        lp = matmod.resolve(scene.materials, hit.material_id, hit.uv, hit.p, scene.textures)
        # direct lighting at every camera vertex
        lt, pmf = common.select_light_uniform(lights, s1(smp.bounce_dim(bounce, 5)))
        ld_b, nee_rays = common.estimate_direct(
            scene, lights, lp, kinds, frame, hit.p, hit.ns, hit.ng, wo, lt, pmf,
            s2(smp.bounce_dim(bounce, 3)), s2(smp.bounce_dim(bounce, 6)),
            s1(smp.bounce_dim(bounce, 2)), active, return_rays=True)
        rays = rays + nee_rays
        ld = ld + torch.where(active[..., None], beta * ld_b, 0.0)

        # the visible point at the first diffuse vertex; the path stops there
        is_diffuse = torch.zeros_like(active)
        for k in DIFFUSE_KINDS:
            is_diffuse = is_diffuse | (lp.kind == k)
        store_now = active & is_diffuse & ~stored
        s3 = store_now[..., None]
        for k, src in (("p", hit.p), ("wo", wo), ("ns", hit.ns), ("ng", hit.ng),
                       ("dpdu", hit.dpdu), ("beta", beta), ("uv", hit.uv)):
            vp[k] = torch.where(s3, src, vp[k])
        vp["mid"] = torch.where(store_now, hit.material_id, vp["mid"])
        vp["valid"] = vp["valid"] | store_now
        stored = stored | store_now
        active = active & ~store_now

        # continue through specular surfaces only
        wo_l = frame.to_local(wo)
        wi_l, f, pdf, spec, _ = matmod.sample(lp, kinds, wo_l, s1(smp.bounce_dim(bounce, 2)),
                                              s2(smp.bounce_dim(bounce, 0)))
        wi = frame.to_world(wi_l)
        good = active & (pdf > 0) & (luminance(f) > 0)
        beta = torch.where(good[..., None],
                           beta * f * (vm.absdot(wi, hit.ns)
                                       / torch.clamp(pdf, min=f32(1e-12)))[..., None], beta)
        active = good
        specular_bounce = spec
        o = vm.offset_ray_origin(hit.p, hit.ng, wi)
        d = wi
    return ld, vp, rays


def _photon_pass(scene, cfg, it):
    """Emit and walk photons_per_iter photons. Returns the deposits over
    (depth × photons), flat: position, incoming direction (the photon's
    travel reversed), power β, valid; and the rays traced."""
    p_count = cfg.photons_per_iter
    lights = scene.lights
    kinds = scene.materials.kinds_present
    scfg = cfg.sampler
    dev = scene.device
    pid = torch.arange(p_count, dtype=torch.int64, device=dev) + PHOTON_ID0
    sid = torch.full((p_count,), it, dtype=torch.int64, device=dev)

    def s1(dim):
        return smp.sample_1d(scfg, pid, sid, dim)

    def s2(dim):
        return smp.sample_2d(scfg, pid, sid, dim)

    lt, pmf, _ = scene.light_power.sample_discrete(s1(0))
    le = lightsmod.sample_le(lights, scene, lt, s2(1), s2(3), scene.world_radius)
    cos0 = vm.absdot(le["ng_l"], le["d"])
    beta = le["le"] * cos0[..., None] / torch.clamp(
        (pmf * le["pdf_pos"] * le["pdf_dir"])[..., None], min=f32(1e-12))
    active = luminance(beta) > 0
    o = vm.offset_ray_origin(le["o"], le["ng_l"], le["d"])
    d = le["d"]

    deposits = []
    rays = torch.zeros((), dtype=torch.float32, device=dev)
    for bounce in range(cfg.max_depth):
        rays = rays + active.to(torch.float32).sum()
        hit = scenemod.intersect(scene, o, d, active=active)
        active = active & hit.valid & (hit.material_id >= 0)
        # deposit after the first bounce (direct light is the camera pass's NEE)
        deposits.append((hit.p, -d, beta, active & (bounce > 0)))

        frame = common.shading_frame(hit)
        lp = matmod.resolve(scene.materials, hit.material_id, hit.uv, hit.p, scene.textures)
        wi_l, f, pdf, _, _ = matmod.sample(lp, kinds, frame.to_local(-d),
                                           s1(smp.bounce_dim(bounce, 2) + 50),
                                           s2(smp.bounce_dim(bounce, 0) + 50))
        wi = frame.to_world(wi_l)
        bnew = beta * f * (vm.absdot(wi, hit.ns) / torch.clamp(pdf, min=f32(1e-12)))[..., None]
        good = active & (pdf > 0) & (luminance(f) > 0)
        # photon Russian roulette
        q = torch.clamp(1.0 - luminance(bnew) / torch.clamp(luminance(beta), min=f32(1e-12)),
                        min=0.0)
        survive = s1(smp.bounce_dim(bounce, 4) + 50) >= q
        beta = torch.where((good & survive)[..., None],
                           bnew / torch.clamp(1.0 - q, min=f32(1e-6))[..., None], bnew)
        active = good & survive
        o = vm.offset_ray_origin(hit.p, hit.ng, wi)
        d = wi
    return tuple(torch.cat([dp[k] for dp in deposits], 0) for k in range(4)) + (rays,)


def _vp_shading(scene, vp):
    """The visible points' material parameters, each field with a photon
    axis of 1 to broadcast against, their frame and local wo."""
    lp = matmod.resolve(scene.materials, vp["mid"], vp["uv"], vp["p"], scene.textures)
    lp = dataclasses.replace(lp, **{
        f.name: getattr(lp, f.name)[:, None] for f in dataclasses.fields(lp)
        if torch.is_tensor(getattr(lp, f.name)) and getattr(lp, f.name).dim()})
    b = vm.normalize(vm.cross(vp["ns"], vp["dpdu"]))
    t = vm.cross(b, vp["ns"])
    return lp, t, b, vm.to_local(vp["wo"], t, b, vp["ns"])


def _deposit(scene, vp, lp, t, b, wo_l, ph_wi, ph_beta, near):
    """Σ over photon axis 1 of β_ph · f(wo, wi) where `near`, and the count."""
    wi_l = vm.to_local(ph_wi, t[:, None], b[:, None], vp["ns"][:, None])
    f = matmod.evaluate_f(lp, scene.materials.kinds_present,
                          torch.broadcast_to(wo_l[:, None], wi_l.shape), wi_l)
    contrib = torch.where(near[..., None], f * ph_beta, 0.0)
    return contrib.sum(1), near.sum(1).to(torch.float32)


def _gather(scene, vp, radius2, ph_p, ph_wi, ph_beta, ph_ok):
    """Dense gathering: the photons within each visible point's radius,
    in chunks of photons. Returns (phi (HW, 3), m (HW,))."""
    hw = vp["p"].shape[0]
    lp, t, b, wo_l = _vp_shading(scene, vp)
    p_total = ph_p.shape[0]
    chunk = max(1, min(p_total, 64 * 1024 * 1024 // max(hw, 1)))
    phi = torch.zeros((hw, 3), dtype=torch.float32, device=vp["p"].device)
    m = torch.zeros((hw,), dtype=torch.float32, device=vp["p"].device)
    for lo in range(0, p_total, chunk):
        sl = slice(lo, lo + chunk)
        dist2 = ((vp["p"][:, None, :] - ph_p[sl][None]) ** 2).sum(-1)
        near = vp["valid"][:, None] & ph_ok[sl][None] & (dist2 <= radius2[:, None])
        dphi, dm = _deposit(scene, vp, lp, t, b, wo_l, ph_wi[sl][None], ph_beta[sl][None],
                            near)
        phi, m = phi + dphi, m + dm
    return phi, m


def _hash3(ix, iy, iz, hsize):
    """Hash of integer cell coordinates in wrapping uint32 arithmetic,
    masked to hsize (a power of two)."""
    h = mul32(as_u32(ix), 73856093) ^ mul32(as_u32(iy), 19349663) \
        ^ mul32(as_u32(iz), 83492791)
    return h & (hsize - 1)


def _gather_grid(scene, vp, radius2, ph_p, ph_wi, ph_beta, ph_ok, max_per_cell=32):
    """Gathering through a hash grid: the cell edge is the largest ball's
    diameter, photons are stably sorted by their cell's hash, and each
    visible point scans the (deduplicated) segments of the 8 cells its
    ball can touch, at most max_per_cell photons each. Returns (phi (HW,
    3), m (HW,), dropped: photon-cell entries over the cap, a 0-dim
    tensor)."""
    hw = vp["p"].shape[0]
    dev = vp["p"].device
    lp, t, b, wo_l = _vp_shading(scene, vp)
    p_total = ph_p.shape[0]
    hsize = 1 << max(int(np.ceil(np.log2(max(hw, 1)))) + 1, 10)
    r_max = torch.sqrt(torch.where(vp["valid"], radius2, 0.0).amax())
    cell = torch.clamp(2.0 * r_max, min=f32(1e-6))
    inv_cell = 1.0 / cell

    pc = torch.floor(ph_p * inv_cell).to(torch.int64)
    ph_h = torch.where(ph_ok, _hash3(pc[:, 0], pc[:, 1], pc[:, 2], hsize), hsize)
    order = torch.argsort(ph_h, stable=True)     # stable: the kept photons are the reference's
    ph_h_s = ph_h[order]
    rec = torch.cat([ph_p, ph_wi, ph_beta], 1)[order]

    cells = torch.arange(hsize, dtype=torch.int64, device=dev)
    seg_len = torch.searchsorted(ph_h_s, cells, right=True) - torch.searchsorted(ph_h_s, cells)
    dropped = torch.clamp(seg_len - max_per_cell, min=0).sum()

    r_vp = torch.sqrt(torch.clamp(radius2, min=0.0))[..., None]
    lo = torch.floor((vp["p"] - r_vp) * inv_cell).to(torch.int64)
    hi = torch.floor((vp["p"] + r_vp) * inv_cell).to(torch.int64)
    phi = torch.zeros((hw, 3), dtype=torch.float32, device=dev)
    m = torch.zeros((hw,), dtype=torch.float32, device=dev)
    probed = []     # buckets scanned already: the lo == hi case and hash collisions
    slots = torch.arange(max_per_cell, dtype=torch.int64, device=dev)
    for cx in range(2):
        for cy in range(2):
            for cz in range(2):
                hv = _hash3((lo if cx == 0 else hi)[:, 0], (lo if cy == 0 else hi)[:, 1],
                            (lo if cz == 0 else hi)[:, 2], hsize)
                dup = torch.zeros((hw,), dtype=torch.bool, device=dev)
                for prev in probed:
                    dup = dup | (hv == prev)
                probed.append(hv)
                start = torch.searchsorted(ph_h_s, hv)
                end = torch.minimum(torch.searchsorted(ph_h_s, hv, right=True),
                                    start + max_per_cell)
                idx = start[:, None] + slots
                ok = (idx < end[:, None]) & ~dup[:, None] & vp["valid"][:, None]
                r = rec[torch.clamp(idx, max=p_total - 1)]          # (HW, M, 9)
                d2 = ((vp["p"][:, None] - r[..., 0:3]) ** 2).sum(-1)
                near = ok & (d2 <= radius2[:, None])
                dphi, dm = _deposit(scene, vp, lp, t, b, wo_l, r[..., 3:6], r[..., 6:9], near)
                phi, m = phi + dphi, m + dm
    return phi, m, dropped


def gather_method(cfg: SPPMConfig):
    """The gather a config runs: "auto" is dense up to 2^28 (visible
    point, photon) pairs, the grid above."""
    if cfg.gather != "auto":
        return cfg.gather
    return "grid" if cfg.height * cfg.width * cfg.photons_per_iter * cfg.max_depth > (1 << 28) \
        else "dense"


def render(scene, camera, cfg: SPPMConfig):
    """Full SPPM render → (H, W, 3); with cfg.return_stats, (image,
    {"photons_dropped": int, "rays_traced": scalar tensor})."""
    h, w = cfg.height, cfg.width
    hw = h * w
    dev = scene.device
    f3 = dict(dtype=torch.float32, device=dev)
    radius2 = torch.full((hw,), cfg.initial_radius ** 2, **f3)
    n_acc = torch.zeros((hw,), **f3)
    tau = torch.zeros((hw, 3), **f3)
    ld_acc = torch.zeros((hw, 3), **f3)
    method = gather_method(cfg)
    if method not in ("dense", "grid"):
        raise ValueError(f"gather {cfg.gather!r}: expected 'dense', 'grid' or 'auto'")

    dropped_total = 0
    rays = torch.zeros((), **f3)
    for it in range(cfg.n_iterations):
        ld, vp, r_cam = _camera_pass(scene, camera, cfg, it)
        ph_p, ph_wi, ph_beta, ph_ok, r_ph = _photon_pass(scene, cfg, it)
        rays = rays + r_cam + r_ph
        if method == "grid":
            phi, m, dropped = _gather_grid(scene, vp, radius2, ph_p, ph_wi, ph_beta, ph_ok,
                                           cfg.max_photons_per_cell)
            dropped_total += int(dropped)      # one host sync an iteration
        else:
            phi, m = _gather(scene, vp, radius2, ph_p, ph_wi, ph_beta, ph_ok)
        # radius and flux update
        has = m > 0
        n_new = n_acc + cfg.alpha * m
        ratio = torch.where(has, n_new / torch.clamp(n_acc + m, min=f32(1e-6)), 1.0)
        radius2 = torch.where(has, radius2 * ratio, radius2)
        tau = torch.where(has[..., None], (tau + vp["beta"] * phi) * ratio[..., None], tau)
        n_acc = n_new
        ld_acc = ld_acc + ld

    if dropped_total:
        logging.getLogger(__name__).warning(
            "SPPM grid gather dropped %d photon-cell entries (max_photons_per_cell=%d too "
            "small for the photon density); radiance is underestimated near bright caustics",
            dropped_total, cfg.max_photons_per_cell)
    # the photon count times π, in float32 as the reference computes it
    n_pi = float(np.float32(cfg.n_iterations * cfg.photons_per_iter) * np.float32(PI))
    l_indirect = tau / (n_pi * torch.clamp(radius2[..., None], min=f32(1e-12)))
    img = (ld_acc / cfg.n_iterations + l_indirect).reshape(h, w, 3)
    if cfg.return_stats:
        return img, {"photons_dropped": dropped_total, "rays_traced": rays}
    return img
