"""Render traffic: a closed loop with one frame in flight. Each frame is
one `driver.render(scene, camera, cfg, li)` call of the port, with
return_stats, at the mix's size, sampler and integrator and a sampler
seed of its own, ended by torch.cuda.synchronize()."""
from __future__ import annotations

import itertools
import random
import time

from . import check, roofline, trace
from .pkg import PORT, Pkg, frame_seed
from .reference import Renderer, free_device, integrator_args


class Port:
    """The port's side of a render cell: scene and camera built once."""

    def __init__(self, run):
        self.run = run
        self.pkg = Pkg(PORT)
        t0 = time.perf_counter()
        self.scene = self.pkg.scene(run.conf, run.device)
        run.sync()
        run.scene_build_s = time.perf_counter() - t0
        self.camera = self.pkg.camera(run.conf, run.traffic, run.device)

    def frame(self, seed):
        run = self.run
        cfg = self.pkg.render_config(run.traffic, seed)
        li = self.pkg.make_li(run.traffic, cfg, self.camera, return_stats=True)
        with run.spans("render"):
            img, _stats = self.pkg.driver.render(self.scene, self.camera, cfg, li)
        with run.spans("sync"):
            run.sync()
        return img


def roofline_of(port, seeds):
    """The tracer's least times, counted from the profiled frames rendered
    again (the same seeds give the same rays) outside the profile, so the
    capture's tensors change nothing the trace saw. {kind: summary}"""
    clmod = port.pkg.imp("geom.cluster")
    out = {}
    for seed in seeds:
        cap = roofline.Capture(clmod)
        with cap.active():
            port.frame(seed)
        for kind in ("closest", "occluded"):
            out[kind] = roofline.add(out.get(kind), roofline.summarize(cap, kind))
    return out


def execute(run):
    """Set-up, the window (or the traced frames) and the check of one
    render run. Fills run.result_* fields."""
    t = run.traffic
    integrator_args(t)          # a mix the reference cannot follow fails before set-up
    port = Port(run)
    for i in range(t["warmup_frames"]):
        port.frame(frame_seed(run.seed, "warmup", i))
    run.end_setup()
    seeds, imgs, times = [], [], []
    if not run.trace:
        t0 = time.perf_counter()
        while True:
            seed = frame_seed(run.seed, "frame", len(seeds))
            a = time.perf_counter()
            img = port.frame(seed)
            times.append(time.perf_counter() - a)
            seeds.append(seed)
            imgs.append(img.cpu())
            if time.perf_counter() - t0 >= run.seconds:
                break
        run.window(time.perf_counter() - t0, times)
    else:
        more = itertools.count()
        run.untraced_items(lambda: port.frame(frame_seed(run.seed, "untraced", next(more))),
                           t["traced_frames"])
        prof = trace.profiler()
        with prof:
            for i in range(t["traced_frames"]):
                seeds.append(frame_seed(run.seed, "frame", i))
                with run.spans("frame"):
                    imgs.append(port.frame(seeds[-1]))
        imgs = [x.cpu() for x in imgs]
        run.traced(trace.read(prof), "frame", len(seeds), roofline_of(port, seeds))
    run.read_memory()
    del port
    free_device()
    k = random.Random(run.seed).randrange(len(seeds))
    ref = Renderer(run.conf, t, run.device)
    numbers = check.image_numbers(imgs[k], ref.frame(seeds[k]))
    run.judge(numbers, attempted=len(seeds))
