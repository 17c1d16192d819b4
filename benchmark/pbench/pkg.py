"""The harness's adapter to the port (pbrt_tpu_torch). A configuration's
file holds its scene and camera as data, which the harness hands to the
port's api.SceneBuilder and camera constructor here and to the plain
reference (plainref/) there; a traffic mix names the port's integrator.
Adding either takes data alone."""
from __future__ import annotations

import hashlib
import importlib

PORT = "pbrt_tpu_torch"


def frame_seed(seed, *key):
    """The sampler seed of one frame or step: a 31-bit hash of --seed and
    the frame's key, so no two frames of a run repeat work."""
    h = hashlib.sha256("/".join(str(k) for k in (seed,) + key).encode()).digest()
    return int.from_bytes(h[:4], "little") & 0x7FFFFFFF


class Pkg:
    def __init__(self, root=PORT):
        self.root = root
        imp = lambda m: importlib.import_module(f"{root}.{m}")   # noqa: E731
        self.driver = imp("integrate.driver")
        self.samplers = imp("core.samplers")
        self.filters = imp("film.filters")
        self.film = imp("film.film")
        self.imp = imp

    def scene(self, conf, device):
        """The configuration's scene through api.SceneBuilder: its material
        rows in order, its quads, spheres and area-light quads; triangles
        traced through the cluster set."""
        b = self.imp("api").SceneBuilder()
        mats = [getattr(b, m["kind"])(**{k: v for k, v in m.items() if k != "kind"})
                for m in conf["materials"]]
        for q in conf["quads"]:
            b.add_quad(*q["corners"], mats[q["material"]])
        for s in conf.get("spheres", ()):
            b.add_sphere(s["center"], s["radius"], mats[s["material"]])
        for lq in conf["area_lights"]:
            b.area_light_quad(*lq["corners"], radiance=lq["radiance"])
        return b.build(True, device)

    def camera(self, conf, traffic, device):
        c = conf["camera"]
        c2w = self.imp("core.transform").look_at_np(c["pos"], c["look"], c["up"])
        return self.imp("cameras.cameras").make_perspective(
            c2w, c["fov_deg"], (traffic["height"], traffic["width"]), device)

    def render_config(self, traffic, seed):
        t = traffic
        return self.driver.RenderConfig(
            width=t["width"], height=t["height"], spp=t["spp"], max_depth=t["max_depth"],
            sampler=self.samplers.SamplerConfig(kind=t["sampler"], spp=t["spp"], seed=seed),
            filter=self.filters.Filter(**t.get("filter", {})),
            samples_per_batch=t.get("samples_per_batch", 0))

    def make_li(self, traffic, cfg, camera, return_stats):
        li = traffic["li"]
        kw = {k: li[k] for k in ("rr_start", "compact_from")}
        return self.imp(f"integrate.{li['integrator']}").make_li(
            cfg, camera=camera, return_stats=return_stats, **kw)
