"""A plain volumetric path tracer for a configuration's scene filled with
one homogeneous medium: PBRT-v3's VolPathIntegrator (Pharr, Jakob and
Humphreys, Physically Based Rendering, 3rd ed., §15.2) with its
HomogeneousMedium (§11.3) and the Henyey-Greenstein phase function
(§11.2), written from those definitions over the surfaces, lights,
camera, sample stream and tracing of path.py.

At every bounce a free flight is sampled on the segment to the next
surface: on a channel chosen uniformly, t = -ln(1 - u) / sigma_t[ch];
the throughput takes sigma_s Tr / pdf where the flight stops in the
medium and Tr / pdf where it reaches the surface, pdf the mean over the
channels of sigma_t Tr or of Tr. A medium event estimates the light at
its point (the phase function's value times Tr to the light point, MIS
against the phase sample) and continues along an HG sample; a surface
event estimates the light through the BSDF (times Tr over the shadow
segment, MIS against the BSDF sample) and continues along the BSDF
sample. Russian roulette from bounce `rr_start` on, on the largest
channel of the throughput. Rays are traced by testing every triangle
and every sphere.

Departures from PBRT-v3, each the estimator the configuration's traffic
states:
- the medium fills the whole scene: every lane starts in it and no
  surface is a medium interface;
- a ray that leaves the scene travels 2 * world_radius through the
  medium (PBRT's is infinite), world_radius derived as the scene builder
  derives it: the half-diagonal of the bounding box of the triangles'
  corners and of each sphere's box, plus 1e-4;
- the last segment, after `depth` bounces, samples no flight: the
  emission it finds is attenuated by Tr;
- both shadow rays of a bounce (from the medium point, with no offset,
  and from the surface) end 0.1% short of the light point, and the
  transmittance is taken over the whole distance to it;
- the HG sample is drawn in the frame about wo of Duff et al. (2017), as
  path.py's `basis`; PBRT builds it with CoordinateSystem. The
  distribution is the same;
- one uniform a bounce per purpose, from the stream's dimensions (the
  bounce slots of sampler.py, offset by 1000 for the channel, 2000 for
  the phase sample and 3000 / 3001 for the medium event's light choice
  and light sample).

`lowp` makes the control: the same tracer with every ray it traces
rounded to bfloat16, and each lane's radiance too."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from . import sampler as smp
from .path import (RAY_EPS, Hit, basis, bf16, bsdf_sample, camera_rays, cross, dot, emitted,
                   lanes, light_sample, lum, matte_f, occluded, offset, power)
from .scene import MATTE

INV_4PI = 1.0 / (4.0 * math.pi)
SLOT_FLIGHT = 7                     # the free flight's bounce slot
DIM_CHANNEL = 1000                  # offsets of the medium's dimensions from their slots
DIM_PHASE = 2000
DIM_MED_SELECT = 3000
DIM_MED_LIGHT2 = 3001


@dataclass
class Medium:
    sigma_a: torch.Tensor       # (3,)
    sigma_s: torch.Tensor       # (3,)
    g: float

    @property
    def sigma_t(self):
        return self.sigma_a + self.sigma_s


def medium(conf, device):
    """The configuration's homogeneous medium."""
    m = conf["medium"]
    if m["kind"] != "homogeneous":
        raise ValueError(f"the plain reference renders a homogeneous medium, not {m['kind']!r}")
    f = dict(dtype=torch.float32, device=device)
    return Medium(torch.tensor(np.broadcast_to(np.float32(m["sigma_a"]), (3,)).copy(), **f),
                  torch.tensor(np.broadcast_to(np.float32(m["sigma_s"]), (3,)).copy(), **f),
                  float(m["g"]))


def world_radius(conf):
    """Half the diagonal of the scene's bounds, plus 1e-4, as float32: the
    quads' and area lights' corners, and each sphere's box."""
    pts = [np.asarray(q["corners"], np.float32) for q in conf["quads"] + conf["area_lights"]]
    for s in conf.get("spheres", ()):
        c, r = np.asarray(s["center"], np.float32), np.float32(s["radius"])
        pts.append(np.stack([c - r, c + r]))
    allp = np.concatenate(pts)
    lo, hi = allp.min(0), allp.max(0)
    radius = float(np.linalg.norm(hi - (lo + hi) / 2.0)) + 1e-4
    return float(np.float32(radius))


def hg(cos_theta, g):
    """The Henyey-Greenstein phase function of the cosine between wo and wi."""
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return INV_4PI * (1.0 - g * g) / (denom * torch.sqrt(torch.clamp(denom, min=1e-8)))


def hg_sample(wo, g, u2):
    """wi about wo whose density is hg(wo . wi, g), and that density."""
    if abs(g) < 1e-3:
        cos_t = 1.0 - 2.0 * u2[:, 0]
    else:
        sq = (1.0 - g * g) / (1.0 + g - 2.0 * g * u2[:, 0])
        cos_t = -(1.0 + g * g - sq * sq) / (2.0 * g)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * math.pi * u2[:, 1]
    v1 = basis(wo)
    v2 = cross(wo, v1)
    wi = (sin_t * torch.cos(phi))[:, None] * v1 + (sin_t * torch.sin(phi))[:, None] * v2 \
        + cos_t[:, None] * wo
    return wi, hg(cos_t, g)


def transmittance(med, dist):
    """Beer-Lambert Tr (N, 3) over distances dist (N,)."""
    return torch.exp(-med.sigma_t * dist[:, None])


def free_flight(med, dist, u, u_ch):
    """A flight along segments of length dist: (stopped in the medium, t,
    throughput weight (N, 3))."""
    ch = torch.clamp((u_ch * 3).to(torch.int64), max=2)
    sig = med.sigma_t[ch]
    t = -torch.log(torch.clamp(1.0 - u, min=1e-10)) / torch.clamp(sig, min=1e-10)
    stopped = t < dist
    t = torch.minimum(t, dist)
    tr = transmittance(med, t)
    density = torch.where(stopped[:, None], med.sigma_t * tr, tr)
    pdf = torch.clamp(density.sum(-1) / 3.0, min=1e-20)
    w = torch.where(stopped[:, None], tr * med.sigma_s, tr) / pdf[:, None]
    return stopped, t, w


def radiance(sc, med, o, d, pixel, sample, seed, depth, rr_start, radius, kd, emit,
             lowp=False):
    """Radiance along camera rays (N, 3) of lanes (pixel, sample)."""
    q = bf16 if lowp else (lambda x: x)
    n = o.shape[0]
    dev = o.device
    st = smp.Stream(seed, pixel, sample)
    far = float(np.float32(2.0 * radius))
    nl = sc.n_lights
    L = torch.zeros((n, 3), device=dev)
    beta = torch.ones((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    prev_spec = torch.ones_like(active)
    prev_pdf = torch.zeros(n, device=dev)
    prev_p = o
    hit = Hit(sc, q(o), q(d), torch.full((n,), math.inf, device=dev))
    for b in range(depth):
        wo = -d
        seg = torch.where(hit.valid, hit.t, far)
        dim = smp.bounce_dim(b, SLOT_FLIGHT)
        in_med, t, w = free_flight(med, seg, st.u1(dim), st.u1(dim + DIM_CHANNEL))
        in_med = in_med & active
        beta = torch.where(active[:, None], beta * w, beta)
        p_med = o + t[:, None] * d
        reach = active & ~in_med
        L = L + beta * emitted(sc, emit, hit, d, prev_p, prev_pdf, prev_spec, reach)

        # medium event: the light through the phase function, and an HG sample
        dim = smp.bounce_dim(b, smp.SLOT_SELECT)
        lt_m = torch.clamp((st.u1(dim + DIM_MED_SELECT) * nl).to(torch.int64), max=nl - 1)
        wi_m, li_m, pdf_lm, dist_m = light_sample(sc, emit, lt_m, p_med,
                                                  st.u2(dim + DIM_MED_LIGHT2))
        ph = hg(dot(wo, wi_m), med.g)
        nee_m = li_m * transmittance(med, dist_m) \
            * (ph * power(pdf_lm, ph) / torch.clamp(pdf_lm, min=1e-12))[:, None] * nl
        usable_m = in_med & (pdf_lm > 0.0)
        nee_m = torch.where(usable_m[:, None], beta * nee_m, 0.0)
        tmax_m = torch.where(usable_m, torch.clamp(dist_m * (1.0 - 1e-3), min=RAY_EPS), -1.0)
        wi_ph, pdf_ph = hg_sample(wo, med.g, st.u2(smp.bounce_dim(b, smp.SLOT_BSDF2)
                                                   + DIM_PHASE))

        # surface event: the light through the BSDF, and a BSDF sample
        surf = reach & hit.valid & (hit.mat >= 0)
        mat = torch.clamp(hit.mat, min=0)
        kind, kd_h = sc.kind[mat], kd[mat]
        wo_l = hit.local(wo)
        lt = torch.clamp((st.u1(dim) * nl).to(torch.int64), max=nl - 1)
        wi_l, li, pdf_l, dist = light_sample(sc, emit, lt, hit.p,
                                             st.u2(smp.bounce_dim(b, smp.SLOT_LIGHT2)))
        f_l, pdf_s = matte_f(kd_h, wo_l, hit.local(wi_l))
        f_l = torch.where((kind == MATTE)[:, None], f_l, 0.0) * dot(wi_l, hit.n).abs()[:, None]
        pdf_s = torch.where(kind == MATTE, pdf_s, 0.0)
        usable = surf & (pdf_l > 0.0) & (lum(li) > 0.0) & (lum(f_l) > 0.0)
        o_sh = offset(hit.p, hit.ng, wi_l)
        tmax_sh = torch.where(usable, torch.clamp(dist * (1.0 - 1e-3), min=RAY_EPS), -1.0)
        nee = f_l * li * (power(pdf_l, pdf_s) / torch.clamp(pdf_l, min=1e-12))[:, None]
        nee = torch.where(usable[:, None], beta * nee * transmittance(med, dist) * nl, 0.0)
        wi_loc, f, pdf, spec, _ = bsdf_sample(
            kind, kd_h, sc.kr[mat], sc.kt[mat], sc.eta[mat], wo_l,
            st.u1(smp.bounce_dim(b, smp.SLOT_LOBE)), st.u2(smp.bounce_dim(b, smp.SLOT_BSDF2)))
        wi = hit.world(wi_loc)
        good = surf & (pdf > 0.0) & (lum(f) > 0.0)
        beta = torch.where(good[:, None],
                           beta * f * (dot(wi, hit.n).abs() / torch.clamp(pdf, min=1e-12))[:, None],
                           beta)

        # the lane goes on from its one event
        m3 = in_med[:, None]
        active = in_med | good
        prev_spec = ~in_med & spec
        prev_pdf = torch.where(in_med, pdf_ph, pdf)
        prev_p = torch.where(m3, p_med, hit.p)
        o = torch.where(m3, p_med, offset(hit.p, hit.ng, wi))
        d = torch.where(m3, wi_ph, wi)
        if b >= rr_start:
            qrr = torch.clamp(1.0 - beta.amax(-1), min=0.05)
            live = st.u1(smp.bounce_dim(b, smp.SLOT_RR)) >= qrr
            beta = torch.where((active & live)[:, None],
                               beta / torch.clamp(1.0 - qrr, min=1e-6)[:, None], beta)
            active = active & live
        hit = Hit(sc, q(o), q(d), torch.where(active, math.inf, -1.0))
        occ_m = occluded(sc, q(p_med), q(wi_m), tmax_m)
        occ = occluded(sc, q(o_sh), q(wi_l), tmax_sh)
        L = L + torch.where((usable_m & ~occ_m)[:, None], nee_m, 0.0)
        L = L + torch.where((usable & ~occ)[:, None], nee, 0.0)
    seg = torch.where(hit.valid, hit.t, far)
    L = L + beta * transmittance(med, seg) \
        * emitted(sc, emit, hit, d, prev_p, prev_pdf, prev_spec, active)
    return q(L)


def render(sc, cam, med, spp, seed, depth, rr_start, radius, lowp=False):
    """The (H, W, 3) image: each pixel the mean of its spp samples."""
    torch.backends.cuda.matmul.allow_tf32 = False      # the camera's product in float32
    pixel, sample = lanes(cam.width, cam.height, spp, sc.tri.device)
    o, d = camera_rays(cam, pixel, smp.Stream(seed, pixel, sample))
    rad = radiance(sc, med, o, d, pixel, sample, seed, depth, rr_start, radius, sc.kd,
                   sc.emit, lowp)
    return rad.reshape(spp, cam.height, cam.width, 3).sum(0) / spp
