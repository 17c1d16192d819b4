"""BVH: the host build and a per-lane traversal (counterpart of
pbrt_tpu/geom/bvh.py; src/accelerators/bvh.rs).

The build is the native binned-SAH builder (geom/native_build.py, 12
buckets, bvh.rs:273-473, the one the cluster build uses), flattened
depth-first into LinearBVHNode columns (bvh.rs:129-135, 774-811). The traversal is the reference's stack loop (a 64-entry stack,
children ordered by the direction's sign, bvh.rs:828-932) over the
wavefront in plain PyTorch: every lane carries (node, stack, stack
pointer), and each step moves every live lane one node. The JAX package's
traversal is a lax.while_loop in jnp, no Pallas kernel, so none is owed
here; the cluster tracer is the production path. The loop asks the card
whether any lane is live once every CHECK_EVERY steps, not every step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.types import INF, f32
from . import native_build
from . import triangle as trimod

MAX_LEAF_PRIMS = 4
STACK_DEPTH = 64     # the reference's traversal stack (bvh.rs:840)
CHECK_EVERY = 8      # traversal steps between host checks for a live lane


@dataclass
class BVHArrays:
    """Flattened LinearBVHNode columns (bvh.rs:129-135)."""
    bounds_min: torch.Tensor     # (M, 3) float32
    bounds_max: torch.Tensor     # (M, 3)
    right_or_prim: torch.Tensor  # (M,) int64: interior → 2nd child; leaf → prim offset
    n_prims: torch.Tensor        # (M,) int64: 0 → interior
    axis: torch.Tensor           # (M,) int64 split axis
    prim_order: torch.Tensor     # (T,) int64 permutation of triangle ids

    @property
    def n_nodes(self):
        return self.bounds_min.shape[0]


COLUMNS = ("bounds_min", "bounds_max", "right_or_prim", "n_prims", "axis", "prim_order")


def bvh_from_numpy(arrs, device):
    """BVHArrays from numpy COLUMNS (the JAX package's BVHArrays fields)."""
    t = lambda k, dt: torch.as_tensor(np.asarray(arrs[k]), device=device).to(dt)  # noqa: E731
    return BVHArrays(*(t(k, torch.float32 if k.startswith("bounds") else torch.int64)
                       for k in COLUMNS))


def _prim_bounds(positions, indices):
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    p0, p1, p2 = (positions[indices[:, c]] for c in range(3))
    return np.minimum(np.minimum(p0, p1), p2), np.maximum(np.maximum(p0, p1), p2)


def build_bvh(positions, indices, max_leaf=MAX_LEAF_PRIMS, device=None):
    """BVH over triangles (positions (V, 3), indices (T, 3), T > 0) by the
    native binned-SAH builder. Returns BVHArrays on `device` (cuda unless
    told otherwise)."""
    device = resolve_device(device)
    res = native_build.build_bvh_sah(*_prim_bounds(positions, indices), max_leaf)
    return bvh_from_numpy(dict(zip(COLUMNS, res)), device)


def _inv_dir(d):
    return 1.0 / torch.where(d.abs() < f32(1e-12),
                             torch.where(d < 0, f32(-1e-12), f32(1e-12)), d)


def _slab(bmin, bmax, o, inv_d, t_min, t_max):
    """Bounds3f::intersect_p (geometry.rs:709-751)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_near = torch.maximum(torch.minimum(t0, t1).amax(-1), t_min)
    t_far = torch.minimum(torch.maximum(t0, t1).amin(-1) * f32(1.0001), t_max)
    return t_near <= t_far


def stack_read(stack, sp):
    """stack[lane, sp] where 0 <= sp < depth, else 0 (the JAX one-hot read)."""
    ok = (sp >= 0) & (sp < stack.shape[1])
    v = stack.gather(1, torch.clamp(sp, 0, stack.shape[1] - 1)[:, None])[:, 0]
    return torch.where(ok, v, torch.zeros_like(v))


def stack_write(stack, sp, value, mask):
    """stack[lane, sp] = value where mask and 0 <= sp < depth (the JAX
    one-hot write: a push past the stack is lost)."""
    ok = mask & (sp >= 0) & (sp < stack.shape[1])
    i = torch.clamp(sp, 0, stack.shape[1] - 1)[:, None]
    old = stack.gather(1, i)[:, 0]
    return stack.scatter(1, i, torch.where(ok, value, old)[:, None])


def run_loop(step, state, live):
    """Apply `step` to `state` until no lane is `live`, asking every
    CHECK_EVERY steps (a finished lane's step changes nothing). Returns
    (state, steps run)."""
    steps = 0
    while True:
        for _ in range(CHECK_EVERY):
            state = step(state)
        steps += CHECK_EVERY
        if not bool(live(state).any()):
            return state, steps


def traverse(bvh: BVHArrays, tri, o, d, t_min, t_max, any_hit, return_steps=False):
    """The stack loop over rays o, d (N, 3) in (t_min, t_max) (N,).
    Returns (hit, t_best, idx, b1, b2), and the steps run if asked."""
    n = o.shape[0]
    dev = o.device
    inv_d = _inv_dir(d)
    neg = d < 0.0
    p0a, p1a, p2a = tri.corners()
    last = bvh.prim_order.shape[0] - 1
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    state = (zi, zi, torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev),
             torch.broadcast_to(t_max, (n,)).to(torch.float32).clone(), zi, zf, zf,
             torch.zeros(n, dtype=torch.bool, device=dev))

    def step(s):
        cur, sp, stack, t_best, idx_best, b1, b2, hit = s
        active = cur >= 0
        ci = torch.clamp(cur, min=0)
        hitbox = active & _slab(bvh.bounds_min[ci], bvh.bounds_max[ci], o, inv_d, t_min, t_best)
        nprims, rp = bvh.n_prims[ci], bvh.right_or_prim[ci]
        is_leaf = nprims > 0
        do_leaf = hitbox & is_leaf
        for k in range(MAX_LEAF_PRIMS):     # a leaf's <= MAX_LEAF_PRIMS triangles
            pid = bvh.prim_order[torch.clamp(rp + k, 0, last)]
            h, t, bb1, bb2 = trimod.moller_trumbore(o, d, p0a[pid], p1a[pid], p2a[pid],
                                                    t_min, t_best)
            take = do_leaf & (k < nprims) & h
            t_best = torch.where(take, t, t_best)
            idx_best = torch.where(take, pid, idx_best)
            b1 = torch.where(take, bb1, b1)
            b2 = torch.where(take, bb2, b2)
            hit = hit | take
        first_right = neg.gather(1, bvh.axis[ci][:, None])[:, 0]
        near = torch.where(first_right, rp, ci + 1)
        far = torch.where(first_right, ci + 1, rp)
        push = hitbox & ~is_leaf
        stack = stack_write(stack, sp, far, push)
        sp = sp + push.to(torch.int64)
        done_early = hit if any_hit else torch.zeros_like(hit)
        can_pop = (sp > 0) & active & ~done_early
        popped = stack_read(stack, sp - 1)
        cur = torch.where(push & ~done_early, near, torch.where(can_pop, popped, -1))
        sp = torch.where(push | ~can_pop, sp, sp - 1)
        sp = torch.where(done_early, 0, sp)
        cur = torch.where(active, cur, -1)
        return cur, sp, stack, t_best, idx_best, b1, b2, hit

    (_, _, _, t_best, idx, b1, b2, hit), steps = run_loop(step, state, lambda s: s[0] >= 0)
    out = (hit, t_best, idx, b1, b2)
    return (out, steps) if return_steps else out


def traverse_closest(bvh, tri, o, d, t_min, t_max):
    """Closest hit: (hit, t, tri_idx, b1, b2)."""
    hit, t_best, idx, b1, b2 = traverse(bvh, tri, o, d, t_min, t_max, any_hit=False)
    return hit, torch.where(hit, t_best, INF), idx, b1, b2


def traverse_any(bvh, tri, o, d, t_min, t_max):
    """Any hit: occ (N,) bool."""
    return traverse(bvh, tri, o, d, t_min, t_max, any_hit=True)[0]
