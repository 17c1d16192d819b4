"""Training traffic: inverse rendering, whole steps of the port's
TrainStep (dist/sharding.py) on one rank, a closed loop. Set-up builds
the one TrainStep of diff/demo.training (it renders the target), then
drives it through its first `checked_steps` steps by the window's own
call; those steps are what the reference follows. Every step renders
with a sampler seed of its own."""
from __future__ import annotations

import time

import torch

from . import check, trace
from .pkg import PORT, Pkg, frame_seed
from .reference import free_device, integrator_args


def params(scene):
    """The trained leaves, as the demo's pget reads them."""
    return {"kd": scene.materials.kd.detach().clone(),
            "emit": scene.lights.emit.detach().clone()}


class Port:
    def __init__(self, run):
        self.run = run
        self.pkg = pkg = Pkg(PORT)
        t = run.traffic
        self.demo = pkg.imp("diff.demo")
        t0 = time.perf_counter()
        scene = pkg.scene(run.conf, run.device)
        run.sync()
        run.scene_build_s = time.perf_counter() - t0
        self.camera = pkg.camera(run.conf, t, run.device)
        cfg = pkg.render_config(t, frame_seed(run.seed, "target"))
        li = pkg.make_li(t, cfg, self.camera, return_stats=False)
        mesh = pkg.imp("dist.sharding").make_mesh(1)
        self.step, self.scene, self.target = self.demo.training(
            scene, self.camera, cfg, li, self.perturb, mesh=mesh)
        self.k = 0

    def perturb(self, scene):
        """The traffic's perturbation through the demo's parameter setter:
        the named rows of kd set to a value, emit scaled."""
        p = self.run.traffic["perturb"]
        kd = scene.materials.kd.clone()
        for row, v in p["kd_rows"].items():
            kd[int(row)] = v
        return self.demo.pset(scene, {"kd": kd, "emit": scene.lights.emit * p["emit_scale"]})

    def feed(self):
        """Give the step its next sampler seed."""
        self.k += 1
        t = self.run.traffic
        cfg = self.pkg.render_config(t, frame_seed(self.run.seed, "step", self.k))
        self.step.cfg = cfg
        self.step.li_fn = self.pkg.make_li(t, cfg, self.camera, return_stats=False)

    def one(self):
        self.feed()
        self.scene, loss = self.step(self.scene, self.camera, self.target, self.run.traffic["lr"])
        self.run.sync()
        return loss

    def one_traced(self):
        """One step by its three parts, each timed on the host clock."""
        self.feed()
        s, run, lr = self.step, self.run, self.run.traffic["lr"]
        with run.spans("forward", sync=True):
            loss, p, _ = s.forward(self.scene, self.camera, self.target)
        with run.spans("backward", sync=True):
            grads = s.backward(loss, p)
        with run.spans("update", sync=True):
            self.scene = s.update(self.scene, p, grads, lr)
            loss = s.total_loss(loss)
        return loss


def checked_steps(port, n):
    """The first n steps: (p0, losses, p1, pn)."""
    p = [params(port.scene)]
    losses = []
    for _ in range(n):
        losses.append(float(port.one()))
        p.append(params(port.scene))
    return p[0], losses, p[1], p[-1]


def execute(run):
    t = run.traffic
    integrator_args(t)          # a mix the reference cannot follow fails before set-up
    port = Port(run)
    p0, losses, p1, pn = checked_steps(port, t["checked_steps"])
    for _ in range(t["warmup_steps"]):
        port.one()
    run.end_setup()
    if not run.trace:
        times = []
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            port.one()
            times.append(time.perf_counter() - a)
            if time.perf_counter() - t0 >= run.seconds:
                break
        run.window(time.perf_counter() - t0, times)
        n = len(times)
    else:
        run.untraced_items(port.one, t["traced_steps"])
        prof = trace.profiler()
        with prof:
            for _ in range(t["traced_steps"]):
                with run.spans("step"):
                    port.one_traced()
        n = t["traced_steps"]
        run.traced(trace.read(prof), "step", n, None)
    run.read_memory()
    del port
    free_device()
    ref = reference_steps(run.conf, t, run.device, run.seed, t["checked_steps"])
    run.judge(numbers((p0, losses, p1, pn), ref, t["lr"]), attempted=n)


def numbers(prog, ref, lr):
    """The compared numbers of a program's first steps against the
    reference's: each step's loss, the first gradient as the update
    applied it ((p0 - p1) / lr) and the change after the checked steps,
    the last two by the worst leaf's norm."""
    p0, losses, p1, pn = prog
    r0, rlosses, r1, rn = ref
    grad = lambda a, b: {k: (a[k] - b[k]) / lr for k in a}   # noqa: E731
    delta = lambda a, b: {k: b[k] - a[k] for k in a}          # noqa: E731
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, rlosses)),
            "first_grad_gap": check.leaf_gaps(grad(p0, p1), grad(r0, r1)),
            "change_gap": check.leaf_gaps(delta(p0, pn), delta(r0, rn))}


def reference_steps(conf, traffic, device, seed, n, lowp=False):
    """The reference's first n steps from its own scene, target and
    perturbation, each rendered with the step's seed through the plain
    path tracer under autograd: (p0, losses, p1, pn). With `lowp`, the
    control."""
    from plainref import fit, scene
    sc = scene.build(conf, device)
    cam = scene.camera(conf, traffic["width"], traffic["height"], device)
    integrator_args(traffic)
    return fit.steps(sc, cam, traffic, frame_seed(seed, "target"),
                     [frame_seed(seed, "step", k) for k in range(1, n + 1)], lowp)
