"""The subsurface leg of the path integrator (counterpart of
pbrt_tpu/integrate/path_sss.py).

When the BSDF sample at a subsurface surface transmits, the path leaves
again at an exit point sampled from the tabulated radial profile around
the entry point:

  1. a probe axis from the entry shading frame (ns 1/2, ss 1/4, ts 1/4)
     and a colour channel (uniform of 3),
  2. a radius from the channel's profile CDF and an angle,
  3. a probe segment of length 2·sqrt(r_max² - r²) through the surface:
     PROBE_CHAIN closest-hit launches with a per-lane window, keeping the
     hits on the entry's material and picking one uniformly,
  4. weight Sp / pdf_sp, the pdf summed over the three axes and three
     channels,
  5. at the exit point next-event estimation with the Sw lobe (its own
     shadow launch) and a cosine-sampled continuation.

Lanes without a subsurface event carry zero weights and inert probe rays;
scenes without a subsurface material never reach this module."""
from __future__ import annotations

from dataclasses import fields

import torch

from ..core import vecmath as vm
from ..core.sampling import cosine_sample_hemisphere, power_heuristic
from ..core.types import PI, SHADOW_EPS, divisor, f32
from ..geom import scene as scenemod
from ..geom.types import Hit
from ..lights import lights as lightsmod
from ..shade import bssrdf as bssr

PROBE_CHAIN = 2    # probe hits collected (a bounded IntersectionChain)
DIM_SSS = 4000     # first sample slot of the subsurface stream
PROBE_T_MIN = f32(1e-4)
_AXIS_PROB = (0.25, 0.25, 0.5)   # ss, ts, ns


def _sss_params(mats, mid):
    """Per-lane (sigma_t (N, 3), rho (N, 3), eta (N,))."""
    mid = torch.clamp(mid, min=0)
    scale = torch.clamp(mats.aux[mid, 7:8], min=f32(1e-6))
    sig_a = mats.aux[mid, 0:3] * scale
    sig_s = mats.aux[mid, 3:6] * scale
    sig_t = sig_a + sig_s
    return sig_t, sig_s / torch.clamp(sig_t, min=f32(1e-9)), mats.eta[mid]


def _pdf_sr(table, sig_t_c, rho_c, r):
    """pdf (r measure) that sample_radius gave r for one channel."""
    i_rho = bssr._rho_index(table, rho_c)
    r_opt = r * sig_t_c
    i_r = bssr._r_index(table, r_opt)
    rs = table.radius_samples
    f_r = torch.clamp((r_opt - rs[i_r]) / torch.clamp(rs[i_r + 1] - rs[i_r], min=f32(1e-9)),
                      0.0, 1.0)
    prof = (1 - f_r) * table.profile[i_rho, i_r] + f_r * table.profile[i_rho, i_r + 1]
    return torch.clamp(prof, min=0.0) / torch.clamp(table.rho_eff[i_rho], min=f32(1e-9)) \
        * sig_t_c


def _pdf_sp(table, sig_t, rho, d_local, n_local):
    """Area pdf of the exit point, summed over the 3 probe axes × 3
    channels; d_local and n_local are (po - pi) and the exit normal in
    the entry frame."""
    r_proj = torch.stack([
        torch.sqrt(d_local[..., 1] ** 2 + d_local[..., 2] ** 2),
        torch.sqrt(d_local[..., 2] ** 2 + d_local[..., 0] ** 2),
        torch.sqrt(d_local[..., 0] ** 2 + d_local[..., 1] ** 2)], -1)
    pdf = torch.zeros_like(d_local[..., 0])
    ch_prob = f32(1.0 / 3.0)
    for ax in range(3):
        r = torch.clamp(r_proj[..., ax], min=f32(1e-6))
        for ch in range(3):
            pdf_r = _pdf_sr(table, sig_t[..., ch], rho[..., ch], r)
            pdf = pdf + n_local[..., ax].abs() * _AXIS_PROB[ax] * ch_prob * pdf_r \
                / (f32(2.0 * PI) * r)
    return pdf


def _select(sel, new: Hit, old: Hit) -> Hit:
    """Field-wise where(sel, new, old) over two hit records."""
    out = {}
    for f in fields(Hit):
        a, b = getattr(new, f.name), getattr(old, f.name)
        out[f.name] = torch.where(sel.reshape(sel.shape + (1,) * (b.dim() - sel.dim())), a, b)
    return Hit(**out)


def sample_exit(scene, hit, frame, u_axch, u_r, u_phi, u_pick, is_sss):
    """The subsurface exit point of lanes flagged `is_sss`. Returns
    (exit_hit, sp_weight (N, 3), ok (N,), eta (N,)): the hit at the
    chosen probe hit, Sp / pdf_sp / P(pick), and the lanes whose probe
    found an exit."""
    mats = scene.materials
    table = mats.sss_table
    sig_t, rho, eta = _sss_params(mats, hit.material_id)
    ss, ts, ns = frame.t, frame.b, frame.n
    u = u_axch
    pick_ns = u < 0.5
    pick_ss = (u >= 0.5) & (u < 0.75)
    vz = torch.where(pick_ns[..., None], ns, torch.where(pick_ss[..., None], ss, ts))
    vx = torch.where(pick_ns[..., None], ss, torch.where(pick_ss[..., None], ts, ns))
    vy = vm.cross(vz, vx)

    u_ch = torch.where(pick_ns, u * 2.0, torch.where(pick_ss, (u - 0.5) * 4.0, (u - 0.75) * 4.0))
    ch = torch.clamp((u_ch * 3.0).to(torch.int64), 0, 2)
    sig_t_c = torch.gather(sig_t, -1, ch[..., None])[..., 0]
    rho_c = torch.gather(rho, -1, ch[..., None])[..., 0]
    r, _ = bssr.sample_radius(table, sig_t_c, rho_c, u_r)
    r_max, _ = bssr.sample_radius(table, sig_t_c, rho_c, torch.full_like(u_r, 0.999))
    ok = is_sss & (r > 0.0) & (r < r_max)
    phi = 2.0 * PI * u_phi

    half_l = torch.sqrt(torch.clamp(r_max * r_max - r * r, min=0.0))
    base = hit.p + r[..., None] * (torch.cos(phi)[..., None] * vx
                                   + torch.sin(phi)[..., None] * vy)
    # lanes without an event send an inert probe (t_max -1) from the hit
    # point: theirs would start up to 1e10 away (sigma_t 0 stretches the
    # radius), and the tracers take finite, moderate rays
    o_probe = torch.where(ok[..., None], base + half_l[..., None] * vz, hit.p)
    t_left = 2.0 * half_l
    t_min = torch.full_like(r, PROBE_T_MIN)
    hits = []
    for _ in range(PROBE_CHAIN):
        h = scenemod.intersect(scene, o_probe, -vz, t_min=t_min, t_max=t_left, active=ok)
        hits.append((h, h.valid & (h.material_id == hit.material_id)))
        # a lane whose probe missed is dead for the next one (t_left 0) and
        # keeps its origin (the reference's becomes inf)
        o_probe = torch.where(h.valid[..., None], o_probe - vz * (h.t[..., None] + PROBE_T_MIN),
                              o_probe)
        t_left = torch.clamp(t_left - h.t - PROBE_T_MIN, min=0.0)

    n_found = sum(m.to(torch.int64) for _, m in hits)
    ok = ok & (n_found > 0)
    pick = torch.minimum((u_pick * n_found.to(torch.float32)).to(torch.int64), n_found - 1)
    rank = torch.zeros_like(n_found)
    exit_hit = hits[0][0]
    for h, m in hits:
        exit_hit = _select(ok & m & (rank == pick), h, exit_hit)
        rank = rank + m.to(torch.int64)

    dvec = hit.p - exit_hit.p
    sp = bssr.sr(table, sig_t, rho, vm.length(dvec))
    d_local = torch.stack([vm.dot(ss, dvec), vm.dot(ts, dvec), vm.dot(ns, dvec)], -1)
    n_local = torch.stack([vm.dot(ss, exit_hit.ns), vm.dot(ts, exit_hit.ns),
                           vm.dot(ns, exit_hit.ns)], -1)
    pdf = _pdf_sp(table, sig_t, rho, d_local, n_local)
    pdf = pdf / torch.clamp(n_found.to(torch.float32), min=1.0)
    sp_w = sp / torch.clamp(pdf, min=f32(1e-12))[..., None]
    ok = ok & (pdf > 0.0) & (sp.amax(-1) > 0.0)
    return exit_hit, torch.where(ok[..., None], sp_w, 0.0), ok, eta


def sw_eval(eta, cos_theta):
    """The directional exit lobe f = Sw(w); its pdf is the cosine lobe."""
    return bssr.sw(eta, cos_theta.abs())


def sw_nee(scene, lights, exit_hit, eta, lt, u_light, active):
    """MIS next-event estimation at the exit point with the Sw lobe, its
    shadow ray through scene.occluded. Returns ld (N, 3), not divided by
    the selection pmf."""
    ls = lightsmod.sample_li(lights, scene, lt, exit_hit.p, u_light, scene.world_radius)
    cos_wi = vm.dot(ls["wi"], exit_hit.ns)
    f = sw_eval(eta, cos_wi) * cos_wi.abs()
    pdf_sw = torch.clamp(cos_wi, min=0.0) / divisor(PI, cos_wi.device)
    usable = active & (ls["pdf"] > 0.0) & (f > 0.0) & (cos_wi > 0.0)
    o_sh = vm.offset_ray_origin(exit_hit.p, exit_hit.ns, ls["wi"])
    t_max = torch.clamp(ls["dist"] * f32(1.0 - 1e-3), min=SHADOW_EPS)
    occ = scenemod.occluded(scene, o_sh, ls["wi"], t_max=t_max, active=usable)
    w_l = torch.where(ls["is_delta"], 1.0, power_heuristic(1.0, ls["pdf"], 1.0, pdf_sw))
    contrib = ls["li"] * (f * w_l / torch.clamp(ls["pdf"], min=f32(1e-12)))[..., None]
    return torch.where((usable & ~occ)[..., None], contrib, 0.0)


def sw_sample(exit_hit, eta, u2):
    """Cosine-sample the exit lobe. Returns (wi (N, 3), weight (N,) =
    f |cos| / pdf = Sw·π, pdf (N,))."""
    ns = exit_hit.ns
    t = vm.normalize(exit_hit.dpdu - vm.dot(exit_hit.dpdu, ns)[..., None] * ns)
    b = vm.cross(ns, t)
    w_l = cosine_sample_hemisphere(u2)
    wi = w_l[..., 0:1] * t + w_l[..., 1:2] * b + w_l[..., 2:3] * ns
    cos_t = torch.clamp(w_l[..., 2], min=f32(1e-6))
    return wi, sw_eval(eta, cos_t) * PI, cos_t / divisor(PI, cos_t.device)
