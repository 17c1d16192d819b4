"""The plain reference (plainref/) on one cell, and its control.

The control is the reference put in the port's place in bfloat16, the
next precision below the configurations' float32: every ray it traces
has its origin and direction rounded to bfloat16, and so has each lane's
radiance as the integrator returns it."""
from __future__ import annotations

import gc

import torch

from plainref import path, scene


def free_device():
    """Let go of what the port held before the reference runs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def integrator_args(traffic, lowp=False):
    li = traffic["li"]
    if li["integrator"] != "path" or traffic["sampler"] != "zerotwo" \
            or traffic.get("filter", {}).get("kind", "box") != "box" \
            or traffic.get("filter", {}).get("radius", 0.5) != 0.5 \
            or traffic.get("samples_per_batch", 0) not in (0, traffic["spp"]):
        raise ValueError("the plain reference renders the path integrator with the zerotwo "
                         "sampler and the box filter of radius 0.5, every sample of a frame "
                         "in one wavefront")
    return dict(depth=traffic["max_depth"], rr_start=li["rr_start"],
                compact_from=li["compact_from"], lowp=lowp)


class Renderer:
    """The reference's scene and camera of one cell, built once."""

    def __init__(self, conf, traffic, device):
        self.traffic = traffic
        self.scene = scene.build(conf, device)
        self.camera = scene.camera(conf, traffic["width"], traffic["height"], device)

    @torch.no_grad()
    def frame(self, seed, lowp=False):
        """The reference's image of the frame rendered with sampler seed
        `seed` (the control's when `lowp`)."""
        t = self.traffic
        return path.render(self.scene, self.camera, t["spp"], seed,
                           **integrator_args(t, lowp))
