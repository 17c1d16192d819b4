"""Pixel sharding over the ranks of a torch.distributed process group
(counterpart of pbrt_tpu/dist/sharding.py).

The image's pixel axis is padded to a multiple of the world size and
each rank renders one contiguous block of it, every sample of those
pixels, against a replicated scene; an all_gather puts the per-pixel sums
together. Every random number is keyed by (pixel, sample, dim), so the
sharded render is bit-equal to the one-rank render for any world size.
The inverse-rendering step all-reduces each parameter's gradient (the
reference's psum over the mesh).

The collective backend follows the tensors' device: NCCL for cuda, gloo
for the CPU. A group of the other backend is refused, never worked
around."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..film import film as filmmod
from ..integrate import driver
from ..diff.inverse import grads_of, leaf_params
from ..diff.checkpoint import tree_flatten


class Mesh(NamedTuple):
    """The ranks a render is sharded over: whether they are the default
    process group's (False for one process rendering alone), its world
    size and this process's rank.

    A Mesh names the group and holds no ProcessGroup object: one that
    outlives destroy_process_group is destructed in the interpreter's
    teardown, and there two gloo processes abort ("terminate called
    without an active exception") in about one exit in twenty."""
    grouped: bool
    size: int
    rank: int


BACKEND = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(n=None):
    """The default process group as a Mesh, or a one-rank Mesh of this
    process alone (n = 1, or no group initialised). n, when given, must be
    1 or the world size."""
    if n == 1 or not dist.is_initialized():
        if n not in (None, 1):
            raise ValueError(f"a mesh of {n} ranks needs an initialised process group")
        return Mesh(False, 1, 0)
    world = dist.get_world_size()
    if n not in (None, world):
        raise ValueError(f"a mesh of {n} ranks: the process group has {world}")
    return Mesh(True, world, dist.get_rank())


def check_backend(mesh, device):
    """Raise unless the mesh's group is of the backend for `device`."""
    if not mesh.grouped:
        return
    want, got = BACKEND[device.type], dist.get_backend()
    if got != want:
        raise RuntimeError(f"{device.type} tensors need a {want} process group, not {got}")


def _block_lanes(cfg, mesh, device, sample_lo=0, sample_hi=None):
    """This rank's lanes: (pixel_id, sample_idx), both (S, B) int64, of
    pixels [rank·B, (rank + 1)·B) of the pixel axis padded to size·B.
    Returns (pixel_id, sample_idx, B)."""
    hw = cfg.height * cfg.width
    blk = -(-hw // mesh.size)
    s_hi = cfg.spp if sample_hi is None else sample_hi
    s = s_hi - sample_lo
    pix = torch.arange(mesh.rank * blk, (mesh.rank + 1) * blk, dtype=torch.int64,
                       device=device)
    pixel_id = pix[None, :].expand(s, blk).contiguous()
    sample_idx = (torch.arange(s, dtype=torch.int64, device=device)
                  + sample_lo)[:, None].expand(s, blk).contiguous()
    return pixel_id, sample_idx, blk


def _block_sums(scene, camera, cfg, li_fn, pixel_id, sample_idx):
    """Per-pixel sums of a block: (acc (B, 3), wacc (B,), stats or None)."""
    rad, wt = driver.render_lanes(scene, camera, cfg, li_fn, pixel_id, sample_idx)
    stats = None
    if isinstance(rad, tuple):
        rad, stats = rad
    acc, wacc = filmmod.sums(rad, wt, 1, pixel_id.shape[1])
    return acc[0], wacc[0], stats


def _gather(mesh, x):
    """Concatenate every rank's x along dim 0 (x itself for one rank)."""
    if not mesh.grouped:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def render_sharded(scene, camera, cfg, li_fn, mesh=None, sample_lo=0, sample_hi=None):
    """Forward render with the pixels sharded over the mesh. Returns the
    (H, W, 3) image on every rank, bit-equal to the one-rank render."""
    mesh = mesh if mesh is not None else make_mesh()
    check_backend(mesh, scene.device)
    h, w = cfg.height, cfg.width
    pixel_id, sample_idx, _ = _block_lanes(cfg, mesh, scene.device, sample_lo, sample_hi)
    with torch.no_grad():
        acc, wacc, _ = _block_sums(scene, camera, cfg, li_fn, pixel_id, sample_idx)
        acc = _gather(mesh, acc)[:h * w].reshape(h, w, 3)
        wacc = _gather(mesh, wacc)[:h * w].reshape(h, w)
    return filmmod.resolve(acc, wacc)


class TrainStep:
    """One inverse-rendering step: the mean L2 over all pixels of the
    sharded render against a target, its gradient all-reduced (SUM) over
    the mesh, then p − lr·g. `forward`, `backward` and `update` are its
    three parts, so they can be timed apart; calling it runs all three.

    param_get(scene) -> pytree of tensors; param_set(scene, pytree) ->
    scene. li_fn may return (radiance, stats); `forward` hands the stats on."""

    def __init__(self, cfg, li_fn, param_get, param_set, mesh=None):
        self.cfg, self.li_fn = cfg, li_fn
        self.param_get, self.param_set = param_get, param_set
        self.mesh = mesh if mesh is not None else make_mesh()
        hw = cfg.height * cfg.width
        if hw % self.mesh.size:
            raise ValueError(f"{hw} pixels do not divide over {self.mesh.size} ranks")

    def forward(self, scene, camera, target_img):
        """Returns (this rank's share of the loss, the leaf params, stats)."""
        check_backend(self.mesh, scene.device)
        cfg = self.cfg
        hw = cfg.height * cfg.width
        params = leaf_params(self.param_get(scene))
        pixel_id, sample_idx, blk = _block_lanes(cfg, self.mesh, scene.device)
        acc, wacc, stats = _block_sums(self.param_set(scene, params), camera, cfg,
                                       self.li_fn, pixel_id, sample_idx)
        img = filmmod.resolve(acc, wacc)
        lo = self.mesh.rank * blk
        target = target_img.reshape(hw, 3)[lo:lo + blk]
        return torch.sum((img - target) ** 2) / (hw * 3), params, stats

    def backward(self, loss, params):
        """The gradient of the whole loss: each rank's, summed over the mesh."""
        leaves, unflatten = tree_flatten(params)
        grads = grads_of(loss, leaves)
        if self.mesh.grouped:
            for g in grads:
                dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return unflatten(list(grads))

    def update(self, scene, params, grads, lr):
        new, unflatten = tree_flatten(params)
        step = [p.detach() - lr * g for p, g in zip(new, tree_flatten(grads)[0])]
        return self.param_set(scene, unflatten(step))

    def total_loss(self, loss):
        loss = loss.detach().clone()
        if self.mesh.grouped:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM)
        return loss

    def __call__(self, scene, camera, target_img, lr):
        """Returns (scene with the stepped params, the whole loss)."""
        loss, params, _ = self.forward(scene, camera, target_img)
        grads = self.backward(loss, params)
        return self.update(scene, params, grads, lr), self.total_loss(loss)


# the reference's name for the step of baseline config 5
make_train_step = TrainStep
