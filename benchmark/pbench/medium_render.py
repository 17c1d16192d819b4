"""Render traffic through a participating medium: render.py's closed
loop (one frame in flight, each frame one `driver.render` call with a
sampler seed of its own, the window, the traced frames, the check of a
frame drawn from --seed), with three differences:

- the configuration's scene gets its medium (`"medium"`: homogeneous,
  sigma_a, sigma_s, g) through api.SceneBuilder.set_homogeneous_medium;
- the mix's integrator (volpath) is given rr_start alone: it takes no
  camera and does no compaction;
- the frame is checked against plainref/volpath.py.

No metric of a medium cell reads the tracer's roofline, so it is not
counted. `ported()` puts these into render.py (and into reference.py,
whose Renderer readings.py's render_readings imports) for the length of
a block, so the loop that is measured is render.py's own;
medium_readings.py takes the readings for the cell's limits under it."""
from __future__ import annotations

import contextlib
from unittest import mock

import torch

from plainref import scene as pscene, volpath

from . import reference, render
from .pkg import Pkg


def mix_args(traffic, lowp=False):
    """The reference's arguments for the mix, or ValueError where it
    cannot follow the mix."""
    li = traffic["li"]
    if li["integrator"] != "volpath" or traffic["sampler"] != "zerotwo" \
            or traffic.get("filter", {}).get("kind", "box") != "box" \
            or traffic.get("filter", {}).get("radius", 0.5) != 0.5 \
            or traffic.get("samples_per_batch", 0) not in (0, traffic["spp"]):
        raise ValueError("the plain volumetric reference renders the volpath integrator with "
                         "the zerotwo sampler and the box filter of radius 0.5, every sample "
                         "of a frame in one wavefront")
    return dict(depth=traffic["max_depth"], rr_start=li["rr_start"], lowp=lowp)


class MediumPkg(Pkg):
    def scene(self, conf, device):
        """The scene Pkg.scene builds (its rows, quads, spheres and area
        lights, in that order), filled with the configuration's medium
        before the build."""
        med = conf["medium"]
        if med["kind"] != "homogeneous":
            raise ValueError(f"a medium cell fills its scene with a homogeneous medium, "
                             f"not {med['kind']!r}")
        b = self.imp("api").SceneBuilder()
        mats = [getattr(b, m["kind"])(**{k: v for k, v in m.items() if k != "kind"})
                for m in conf["materials"]]
        for q in conf["quads"]:
            b.add_quad(*q["corners"], mats[q["material"]])
        for s in conf.get("spheres", ()):
            b.add_sphere(s["center"], s["radius"], mats[s["material"]])
        for lq in conf["area_lights"]:
            b.area_light_quad(*lq["corners"], radiance=lq["radiance"])
        b.set_homogeneous_medium(med["sigma_a"], med["sigma_s"], med["g"])
        return b.build(True, device)

    def make_li(self, traffic, cfg, camera, return_stats):
        li = traffic["li"]
        return self.imp(f"integrate.{li['integrator']}").make_li(
            cfg, rr_start=li["rr_start"], return_stats=return_stats)


class Renderer:
    """The plain volumetric reference's scene, medium and camera of one
    cell, built once."""

    def __init__(self, conf, traffic, device):
        self.traffic = traffic
        self.scene = pscene.build(conf, device)
        self.camera = pscene.camera(conf, traffic["width"], traffic["height"], device)
        self.medium = volpath.medium(conf, device)
        self.radius = volpath.world_radius(conf)

    @torch.no_grad()
    def frame(self, seed, lowp=False):
        """The reference's image of the frame rendered with sampler seed
        `seed` (the control's when `lowp`)."""
        t = self.traffic
        return volpath.render(self.scene, self.camera, self.medium, t["spp"], seed,
                              radius=self.radius, **mix_args(t, lowp))


@contextlib.contextmanager
def ported():
    """render.py's loop and readings.py's render_readings, for a medium cell."""
    with mock.patch.multiple(render, Pkg=MediumPkg, Renderer=Renderer,
                             integrator_args=mix_args, roofline_of=lambda port, seeds: None), \
            mock.patch.object(reference, "Renderer", Renderer):
        yield


def execute(run):
    """Set-up, the window (or the traced frames) and the check of one run."""
    with ported():
        render.execute(run)
