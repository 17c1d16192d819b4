"""Unidirectional path tracer, the wavefront pipeline (counterpart of
pbrt_tpu/integrate/path.py: `li`).

    hit = closest_hit(primary)
    for bounce < max_depth:
        emission pickup at `hit`, MIS-weighted against NEE
        NEE light sample at `hit` (shadow ray deferred)
        one BSDF sample -> extension ray; the extension and shadow rays
            are traced together in one fused launch
        throughput update, Russian roulette from bounce `rr_start`
    final emission pickup

Wavefront compaction (`compact_from`) shrinks the lane count on a static
schedule by keeping a uniformly random subset of the live lanes, scaled by
live/kept, so the estimator stays unbiased. Every random number is keyed
by (pixel, sample, dim), so lanes can be reordered freely. A `provider`
(MLT's primary-sample vectors) replaces the sampler: it maps (bounce,
slot) to the lanes' uniforms, and compaction is off under it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import samplers as smp
from ..core import vecmath as vm
from ..core.sampling import power_heuristic
from ..core.spectrum import luminance
from ..core.types import f32
from ..geom import scene as scenemod
from ..geom.types import Hit
from ..lights import lights as lightsmod
from ..shade import materials as matmod
from . import common

DIM_COMPACT = 8000     # sample slot of the compaction subset draw
DIM_TEXLOD = 9000      # sample slot of the anisotropic-footprint jitter


def _compact_width(n0, bounce, compact_from, floor=2048):
    """Static wavefront width for `bounce`: halves each bounce past
    `compact_from`, two extra octaves from the 4th compacted bounce,
    floored at `floor` lanes."""
    shift = bounce - compact_from + 1
    if shift >= 4:
        shift += 2
    shift = min(shift, 7)
    return max(min(n0 >> shift, n0), min(floor, n0))


def _gather_packed(order, arrays):
    """Permute many per-lane tensors with one row gather: each array rides
    as float32 columns — float32 as is, bool as 0/1, int64 as its two
    32-bit words, reinterpreted (no arithmetic touches the bits)."""
    cols, meta = [], []
    for a in arrays:
        c = a[:, None] if a.dim() == 1 else a
        if c.dtype == torch.bool:
            c = c.to(torch.float32)
        elif c.dtype != torch.float32:
            c = c.contiguous().view(torch.float32)
        meta.append((a.dtype, a.dim(), c.shape[1]))
        cols.append(c)
    out = torch.cat(cols, 1)[order]
    res, i = [], 0
    for dtype, nd, k in meta:
        c = out[:, i:i + k]
        i += k
        if dtype == torch.bool:
            c = c > 0.5
        elif dtype != torch.float32:
            c = c.contiguous().view(dtype)
        res.append(c[:, 0] if nd == 1 else c)
    return res


def default_provider(cfg, pixel_id, sample_idx):
    """The sampler as a provider: (sample1, sample2), each (bounce, slot)
    → the lanes' uniforms from the stateless sampler."""
    def sample1(bounce, slot):
        return smp.sample_1d(cfg.sampler, pixel_id, sample_idx, smp.bounce_dim(bounce, slot))

    def sample2(bounce, slot):
        return smp.sample_2d(cfg.sampler, pixel_id, sample_idx, smp.bounce_dim(bounce, slot))

    return sample1, sample2


def _emission_pickup(scene, lights, cfg, hit, d, prev_p, prev_pdf, prev_spec, counts):
    """Radiance of the emitter a ray hit (or the infinite light it
    escaped to), MIS-weighted against the NEE strategy that could have
    sampled it: selection pmf × solid-angle pdf."""
    le_hit = lightsmod.area_light_radiance(lights, hit.light_id, hit.ng, -d)
    le_env = lightsmod.env_radiance(lights, d)
    le = torch.where(hit.valid[..., None], le_hit, le_env)
    got_area = hit.valid & (hit.light_id >= 0)
    pdf_area = lightsmod.pdf_li_area_scene(lights, scene, hit.light_id, prev_p, hit.p, hit.ng)
    sel_area = common.select_light_pmf(scene, cfg.light_strategy, prev_p, hit.light_id)
    pdf_nee = torch.where(got_area, pdf_area * sel_area, 0.0)
    if lights.env_index >= 0:
        env_sel = common.select_light_pmf(scene, cfg.light_strategy, prev_p,
                                          torch.full_like(hit.light_id, lights.env_index))
        pdf_nee = torch.where(~hit.valid, lightsmod.env_pdf_li(lights, d) * env_sel, pdf_nee)
    w = torch.where(prev_spec, 1.0, power_heuristic(1.0, prev_pdf, 1.0, pdf_nee))
    return torch.where(counts[..., None], le * w[..., None], 0.0)


def li(scene, o, d, pixel_id, sample_idx, cfg, rr_start=3, return_stats=False,
       cone=None, compact_from=None, provider=None):
    """Radiance along camera rays o, d (..., 3) for lanes (pixel_id,
    sample_idx). Returns L (..., 3), and with `return_stats` also
    {"rays_traced": scalar tensor, "occupancy": (max_depth,) tensor}.
    `provider` (sample1, sample2) supplies the uniforms in place of the
    sampler (default_provider); compaction is off under it, and the
    texture-footprint jitter takes the centre tap."""
    lights = scene.lights
    kinds = scene.materials.kinds_present
    shp = pixel_id.shape
    dev = o.device
    pixel_id, sample_idx, o, d = common.flat_lanes(pixel_id, sample_idx, o, d)
    n = n0 = pixel_id.numel()
    if provider is None:
        sample1, sample2 = default_provider(cfg, pixel_id, sample_idx)
    else:       # the provider's uniforms, lane-major; its state is indexed by lane
        p1, p2 = provider
        sample1 = lambda bounce, slot: p1(bounce, slot).reshape(n)          # noqa: E731
        sample2 = lambda bounce, slot: p2(bounce, slot).reshape(n, 2)       # noqa: E731
        compact_from = None

    f3 = dict(dtype=torch.float32, device=dev)
    L = torch.zeros((n, 3), **f3)
    beta = torch.ones((n, 3), **f3)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_spec = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = torch.zeros((n,), **f3)
    prev_p = o
    eta_scale = torch.ones((n,), **f3)
    rays_traced = torch.zeros((), **f3)
    occupancy = []
    if cone is None:
        cone = (0.0, f32(0.9 / max(cfg.height, 1)))
    cone_w = torch.full((n,), cone[0], **f3)
    cone_s = torch.full((n,), cone[1], **f3)

    hit = scenemod.intersect(scene, o, d)
    rays_traced = rays_traced + n
    gid = torch.arange(n, dtype=torch.int64, device=dev)
    L_out = None

    for bounce in range(cfg.max_depth):
        if compact_from is not None and bounce >= compact_from:
            m = _compact_width(n0, bounce, compact_from)
            if m < n:
                key = torch.where(active, sample1(bounce, DIM_COMPACT), 2.0)   # dead last
                order = torch.argsort(key, stable=True)[:m]
                live_n = active.to(torch.float32).sum()
                if L_out is None:
                    L_out = torch.zeros((n0, 3), **f3)
                L_out = L_out.index_put((gid,), L, accumulate=True)
                hit_fields = [f.name for f in dataclasses.fields(hit)]
                (beta, eta_scale, cone_w, cone_s, pixel_id, sample_idx, active, gid,
                 d, prev_p, prev_pdf, prev_spec, *hit_vals) = _gather_packed(order, [
                     beta, eta_scale, cone_w, cone_s, pixel_id, sample_idx, active,
                     gid, d, prev_p, prev_pdf, prev_spec,
                     *(getattr(hit, k) for k in hit_fields)])
                hit = Hit(**dict(zip(hit_fields, hit_vals)))
                L = torch.zeros((m, 3), **f3)
                # Russian-roulette compensation when live lanes exceed the width
                scale = torch.clamp(live_n / m, min=1.0)
                beta = torch.where(active[..., None], beta * scale, beta)
                n = m
                sample1, sample2 = default_provider(cfg, pixel_id, sample_idx)

        wo = -d
        occupancy.append(active.to(torch.float32).sum() / n0)
        L = L + beta * _emission_pickup(scene, lights, cfg, hit, d, prev_p, prev_pdf,
                                        prev_spec, active)
        active = active & hit.valid & (hit.material_id >= 0)
        frame = common.shading_frame(hit)

        # ray-cone texture footprint: minor axis from the cone width, one
        # stochastic tap along the major (grazing) axis per sample
        fp_uv = (cone_w + cone_s * torch.where(hit.valid, hit.t, 0.0)) * hit.uv_scale
        cos_i = vm.absdot(d, hit.ns)
        aniso = torch.clamp(1.0 / torch.clamp(cos_i, min=0.125), 1.0, 8.0)
        d_t = d - hit.ns * vm.dot(d, hit.ns)[..., None]
        d_tn = d_t / torch.clamp(vm.length(d_t), min=f32(1e-8))[..., None]
        b_ax = vm.cross(hit.ns, hit.dpdu)
        uv_dir = torch.stack([vm.dot(d_tn, hit.dpdu), vm.dot(d_tn, b_ax)], -1)
        u_j = sample1(bounce, DIM_TEXLOD) - 0.5 if provider is None \
            else torch.zeros((n,), **f3)
        uv_eval = hit.uv + uv_dir * (fp_uv * (aniso - 1.0) * u_j)[..., None]
        lp = matmod.resolve(scene.materials, hit.material_id, uv_eval, hit.p,
                            scene.textures, fp=fp_uv)

        # NEE light half; its shadow ray rides this bounce's extension launch
        lt, pmf = common.select_light(scene, cfg.light_strategy, hit.p, sample1(bounce, 5))
        nee_c, o_sh, wi_sh, tmax_sh, usable, _ = common.nee_light_defer(
            scene, lights, lp, kinds, frame, hit.p, hit.ns, hit.ng, wo, lt,
            sample2(bounce, 3), active)
        rays_traced = rays_traced + usable.to(torch.float32).sum()
        nee_c = torch.where(active[..., None],
                            beta * nee_c / torch.clamp(pmf, min=f32(1e-12))[..., None], 0.0)

        # one BSDF sample: MIS counterpart and path continuation
        wo_l = frame.to_local(wo)
        wi_l, f, pdf, spec, trans = matmod.sample(lp, kinds, wo_l, sample1(bounce, 2),
                                                  sample2(bounce, 0))
        wi = frame.to_world(wi_l)
        good = active & (pdf > 0.0) & (luminance(f) > 0.0)
        beta = torch.where(good[..., None],
                           beta * f * (vm.absdot(wi, hit.ns)
                                       / torch.clamp(pdf, min=f32(1e-12)))[..., None], beta)
        active = good
        eta_scale = torch.where(trans, eta_scale * matmod.eta_scale_on_transmit(lp, wo_l[..., 2]),
                                eta_scale)

        if bounce >= rr_start:
            q = torch.clamp(1.0 - vm.max_component(beta * eta_scale[..., None]), min=f32(0.05))
            survive = sample1(bounce, 6) >= q
            beta = torch.where((active & survive)[..., None],
                               beta / torch.clamp(1.0 - q, min=f32(1e-6))[..., None], beta)
            active = active & survive

        prev_p = hit.p
        prev_pdf = pdf
        prev_spec = spec
        cone_w = cone_w + cone_s * torch.where(hit.valid, hit.t, 0.0)
        lobe_spread = torch.clamp(torch.rsqrt(torch.clamp(pdf, min=2.0)), max=f32(0.7))
        cone_s = torch.where(spec, cone_s, torch.maximum(cone_s, lobe_spread))
        o = vm.offset_ray_origin(hit.p, hit.ng, wi)
        d = wi
        hit, occ = scenemod.intersect_occluded(scene, o, d, o_sh, wi_sh, tmax_sh,
                                               active=active, active_sh=usable)
        L = L + torch.where((usable & ~occ)[..., None], nee_c, 0.0)
        rays_traced = rays_traced + active.to(torch.float32).sum()

    L = L + beta * _emission_pickup(scene, lights, cfg, hit, d, prev_p, prev_pdf,
                                    prev_spec, active)
    if L_out is not None:      # fold compacted lanes back to lane order
        L = L_out.index_put((gid,), L, accumulate=True)
    L = L.reshape(shp + (3,))
    if return_stats:
        return L, {"rays_traced": rays_traced, "occupancy": torch.stack(occupancy)}
    return L


def make_li(cfg, rr_start=3, camera=None, compact_from=None, return_stats=False):
    cone = None
    if camera is not None:
        from ..cameras import cameras as cammod
        cone = cammod.cone_start(camera)
    return lambda scene, o, d, pid, sid: li(scene, o, d, pid, sid, cfg, rr_start,
                                            return_stats=return_stats, cone=cone,
                                            compact_from=compact_from)
