"""Checkpoint and resume (counterpart of pbrt_tpu/diff/checkpoint.py).

Samplers are stateless, so (film sums, next sample index) is the whole
state of a render: resuming re-derives every stream exactly. Parameters
and optimiser state round-trip as flattened pytrees in one .npz, in the
reference's layout: `leaf_{i}` in JAX's flatten order (dict keys sorted,
then tuples and lists in order, None holding no leaf) and `__meta__` as
uint8 JSON, so a file written by either package loads in the other.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..film import film as filmmod
from ..integrate import driver


def tree_flatten(tree):
    """(leaves, unflatten): the leaves of nested dicts, tuples, lists and
    NamedTuples in JAX's flatten order, and a function that puts a list of
    new leaves back into the same structure."""
    leaves = []

    def walk(t):
        if t is None:
            return lambda it: None
        if isinstance(t, dict):
            keys = sorted(t)
            subs = [walk(t[k]) for k in keys]
            return lambda it: {k: s(it) for k, s in zip(keys, subs)}
        if isinstance(t, (tuple, list)):
            subs = [walk(v) for v in t]
            if hasattr(t, "_fields"):
                return lambda it: type(t)(*[s(it) for s in subs])
            return lambda it: type(t)([s(it) for s in subs])
        leaves.append(t)
        return lambda it: next(it)

    build = walk(tree)
    return leaves, lambda new: build(iter(new))


def tree_map(fn, tree):
    leaves, unflatten = tree_flatten(tree)
    return unflatten([fn(x) for x in leaves])


def _numpy(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_pytree(path, tree, meta=None):
    leaves, _ = tree_flatten(tree)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **arrays)


def _meta(data):
    return json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}


def load_pytree(path, like_tree, device=None):
    """Restore a pytree saved by save_pytree (of either package) into the
    structure of `like_tree`; each leaf becomes a tensor on the device of
    the leaf it replaces, or on `device` (resolve_device's) where that
    leaf is no tensor. Returns (tree, meta)."""
    like, unflatten = tree_flatten(like_tree)
    dev = None if all(torch.is_tensor(x) for x in like) else resolve_device(device)
    with np.load(path) as data:
        out = [torch.as_tensor(data[f"leaf_{i}"], device=x.device if torch.is_tensor(x) else dev)
               for i, x in enumerate(like)]
        meta = _meta(data)
    return unflatten(out), meta


class RenderCheckpoint:
    """Accumulating render with save and resume (film sums + sample cursor)."""

    def __init__(self, height, width, device=None):
        device = resolve_device(device)
        self.acc = torch.zeros((height, width, 3), dtype=torch.float32, device=device)
        self.wacc = torch.zeros((height, width), dtype=torch.float32, device=device)
        self.next_sample = 0

    def add_batch(self, radiance_sum, weight_sum, n_samples):
        self.acc = self.acc + radiance_sum
        self.wacc = self.wacc + weight_sum
        self.next_sample += n_samples

    def image(self):
        return filmmod.resolve(self.acc, self.wacc)

    def save(self, path):
        save_pytree(path, (self.acc, self.wacc), meta={"next_sample": self.next_sample})

    @classmethod
    def load(cls, path, device=None):
        device = resolve_device(device)
        with np.load(path) as data:
            acc = torch.as_tensor(data["leaf_0"], device=device)
            wacc = torch.as_tensor(data["leaf_1"], device=device)
            meta = _meta(data)
        ck = cls(acc.shape[0], acc.shape[1], device)
        ck.acc, ck.wacc = acc, wacc
        ck.next_sample = meta["next_sample"]
        return ck


def render_resumable(scene, camera, cfg, li_fn, checkpoint_path=None, save_every=0):
    """driver.render with checkpointing: the same image as a straight
    render at the same spp (stateless sampling, so the resume is exact)."""
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = RenderCheckpoint.load(checkpoint_path, scene.device)
    else:
        ck = RenderCheckpoint(cfg.height, cfg.width, scene.device)
    batch = cfg.samples_per_batch or cfg.spp
    for hi, acc, wacc, _ in driver.accumulate(scene, camera, cfg, li_fn, ck.acc, ck.wacc,
                                              ck.next_sample):
        ck.acc, ck.wacc, ck.next_sample = acc, wacc, hi
        if checkpoint_path and save_every and (hi // batch) % save_every == 0:
            ck.save(checkpoint_path)
    if checkpoint_path:
        ck.save(checkpoint_path)
    return ck.image()
