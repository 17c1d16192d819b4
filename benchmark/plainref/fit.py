"""Plain inverse rendering: the first steps of fitting the albedo table
(kd) and the lights' radiance (emit) back from a perturbed scene, by
plain gradient descent on the mean squared error over every pixel and
channel against a target rendered from the true scene. The gradient is
autograd's through the plain path tracer; after each step kd is clamped
to [0, 1] and emit to at least 0."""
from __future__ import annotations

import torch

from . import path


def perturbed(sc, perturb):
    """(kd, emit) of the scene under the traffic's perturbation: the named
    rows of kd set to a value, emit scaled."""
    kd = sc.kd.clone()
    for row, v in perturb["kd_rows"].items():
        kd[int(row)] = v
    return kd, sc.emit * perturb["emit_scale"]


def steps(sc, cam, t, target_seed, step_seeds, lowp=False):
    """The first len(step_seeds) steps of traffic `t`: (params before,
    the losses, params after one step, params after all), params a dict
    {"kd", "emit"}."""
    kw = dict(depth=t["max_depth"], rr_start=t["li"]["rr_start"],
              compact_from=t["li"]["compact_from"], lowp=lowp)
    with torch.no_grad():
        target = path.render(sc, cam, t["spp"], target_seed, **kw)
    kd, emit = perturbed(sc, t["perturb"])
    kd, emit = torch.clamp(kd, 0.0, 1.0), torch.clamp(emit, min=0.0)
    seen, losses = [{"kd": kd, "emit": emit}], []
    n = cam.height * cam.width * 3
    for seed in step_seeds:
        kd_l, emit_l = kd.clone().requires_grad_(True), emit.clone().requires_grad_(True)
        img = path.render(sc, cam, t["spp"], seed, kd=torch.clamp(kd_l, 0.0, 1.0),
                          emit=torch.clamp(emit_l, min=0.0), **kw)
        loss = ((img - target) ** 2).sum() / n
        g_kd, g_emit = torch.autograd.grad(loss, [kd_l, emit_l], allow_unused=True,
                                           materialize_grads=True)
        kd = torch.clamp(kd_l.detach() - t["lr"] * g_kd, 0.0, 1.0)
        emit = torch.clamp(emit_l.detach() - t["lr"] * g_emit, min=0.0)
        losses.append(float(loss.detach()))
        seen.append({"kd": kd, "emit": emit})
    return seen[0], losses, seen[1], seen[-1]
