"""Faults planted under the timed path, to show that the comparison
fails them: a step that returns its state unchanged, half of the batch
left out with the mean taken over the rest, an answer altered where it
is produced. Each is a context manager that patches the port's module
and restores it. One chip only, so no exchange between chips to leave
out."""
from __future__ import annotations

import contextlib
import importlib

import torch

from .pkg import PORT


def _mod(name):
    return importlib.import_module(f"{PORT}.{name}")


@contextlib.contextmanager
def _patched(mod, attr, value):
    saved = getattr(mod, attr)
    setattr(mod, attr, value)
    try:
        yield
    finally:
        setattr(mod, attr, saved)


# ---- render cells: driver.render is the timed call

def render_unchanged():
    """Every frame returns the first frame's image."""
    drv = _mod("integrate.driver")
    render0, first = drv.render, []

    def render(scene, camera, cfg, li_fn):
        if not first:
            first.append(render0(scene, camera, cfg, li_fn))
        return first[0]
    return _patched(drv, "render", render)


def render_half():
    """Each pixel's image is the mean of the first half of its samples."""
    drv = _mod("integrate.driver")
    render0 = drv.render

    def render(scene, camera, cfg, li_fn):
        return render0(scene, camera, cfg._replace(spp=cfg.spp // 2), li_fn)
    return _patched(drv, "render", render)


def render_altered():
    """The radiance of every 97th pixel's samples is 1% and 0.01 too high."""
    drv = _mod("integrate.driver")
    lanes0 = drv.render_lanes

    def render_lanes(scene, camera, cfg, li_fn, pixel_id, sample_idx):
        def li(sc, o, d, pid, sid):
            out = li_fn(sc, o, d, pid, sid)
            rad = out[0] if isinstance(out, tuple) else out
            rad = torch.where((pid % 97 == 0)[..., None], rad * 1.01 + 0.01, rad)
            return (rad,) + tuple(out[1:]) if isinstance(out, tuple) else rad
        return lanes0(scene, camera, cfg, li, pixel_id, sample_idx)
    return _patched(drv, "render_lanes", render_lanes)


# ---- the train cell: TrainStep's parts are the timed call

def train_unchanged():
    """The update returns the parameters it was given."""
    sh = _mod("dist.sharding")
    return _patched(sh.TrainStep, "update",
                    lambda self, scene, params, grads, lr: scene)


def train_half():
    """The loss is the mean over the first half of the pixels only."""
    sh = _mod("dist.sharding")
    film = _mod("film.film")
    from importlib import import_module
    leaf_params = import_module(f"{PORT}.diff.inverse").leaf_params

    def forward(self, scene, camera, target_img):
        cfg = self.cfg
        hw = cfg.height * cfg.width
        params = leaf_params(self.param_get(scene))
        pixel_id, sample_idx, blk = sh._block_lanes(cfg, self.mesh, scene.device)
        half = blk // 2
        acc, wacc, stats = sh._block_sums(self.param_set(scene, params), camera, cfg,
                                          self.li_fn, pixel_id[:, :half].contiguous(),
                                          sample_idx[:, :half].contiguous())
        img = film.resolve(acc, wacc)
        target = target_img.reshape(hw, 3)[:half]
        return torch.sum((img - target) ** 2) / (half * 3), params, stats
    return _patched(sh.TrainStep, "forward", forward)


def train_altered():
    """The gradient is 1% too large where backward produces it."""
    sh = _mod("dist.sharding")
    backward0 = sh.TrainStep.backward

    def backward(self, loss, params):
        g = backward0(self, loss, params)
        return {k: v * 1.01 for k, v in g.items()}
    return _patched(sh.TrainStep, "backward", backward)


RENDER = {"unchanged": render_unchanged, "half": render_half, "altered": render_altered}
TRAIN = {"unchanged": train_unchanged, "half": train_half, "altered": train_altered}
