"""Shading frames, light selection and the deferred light-sampling half
of next-event estimation (counterpart of pbrt_tpu/integrate/common.py)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import vecmath as vm
from ..core.sampling import power_heuristic
from ..core.spectrum import luminance
from ..core.types import SHADOW_EPS, f32
from ..lights import lights as lightsmod
from ..shade import materials as matmod


class Frame(NamedTuple):
    t: torch.Tensor
    b: torch.Tensor
    n: torch.Tensor

    def to_local(self, v):
        return vm.to_local(v, self.t, self.b, self.n)

    def to_world(self, v):
        return vm.to_world(v, self.t, self.b, self.n)


def shading_frame(hit):
    """Orthonormal shading frame from the hit's dpdu and shading normal."""
    n = hit.ns
    b = vm.normalize(vm.cross(n, hit.dpdu))
    return Frame(vm.cross(b, n), b, n)


def select_light(scene, strategy, p, u):
    """Uniform light selection. Returns (light index, pmf)."""
    if strategy != "uniform":
        raise NotImplementedError(f"light strategy {strategy!r} is not ported yet")
    n = scene.lights.count
    idx = torch.clamp((u * n).to(torch.int64), max=n - 1)
    return idx, torch.full_like(u, 1.0 / n)


def select_light_pmf(scene, strategy, p, light_id):
    """pmf the selection strategy gives `light_id` at p."""
    if strategy != "uniform":
        raise NotImplementedError(f"light strategy {strategy!r} is not ported yet")
    return torch.full(light_id.shape, 1.0 / max(int(scene.lights.count), 1),
                      dtype=torch.float32, device=light_id.device)


def nee_light_defer(scene, lights, lp, kinds_present, frame, p, ns, ng, wo, lt,
                    u_light, active):
    """Light-sampling half of MIS direct lighting without the shadow
    trace. Returns (contrib, o_sh, wi, tmax_sh, usable, ls); the caller
    traces the shadow ray (fused into the bounce's extension launch) and
    applies contrib where unoccluded."""
    ls = lightsmod.sample_li(lights, lt, p, u_light)
    wi = ls["wi"]
    wo_l = frame.to_local(wo)
    wi_l = frame.to_local(wi)
    f = matmod.evaluate_f(lp, kinds_present, wo_l, wi_l) * vm.absdot(wi, ns)[..., None]
    scat_pdf = matmod.pdf(lp, kinds_present, wo_l, wi_l)
    usable = active & (ls["pdf"] > 0.0) & (luminance(ls["li"]) > 0.0) & (luminance(f) > 0.0)
    o_sh = vm.offset_ray_origin(p, ng, wi)
    tmax_sh = torch.clamp(ls["dist"] * f32(1.0 - 1e-3), min=SHADOW_EPS)
    w_l = torch.where(ls["is_delta"], 1.0, power_heuristic(1.0, ls["pdf"], 1.0, scat_pdf))
    contrib = f * ls["li"] * (w_l / torch.clamp(ls["pdf"], min=f32(1e-12)))[..., None]
    contrib = torch.where(usable[..., None], contrib, 0.0)
    return contrib, o_sh, wi, tmax_sh, usable, ls
