"""kd-tree accelerator (counterpart of pbrt_tpu/geom/kdtree.py;
src/accelerators/kdtreeaccel.rs): the SAH build over BoundEdge events on
the host (kdtreeaccel.rs:254+), flattened into explicit columns (the
reference packs its node into a union, kdtreeaccel.rs:40-70), and a
closest-hit traversal with per-lane (node, t-range) stacks in plain
PyTorch, stepped as geom/bvh.py's loop. As in the JAX package there is no
any-hit traversal and geom/scene.py has no kd branch: the kd-tree is a
secondary accelerator, held against the brute-force tracers.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core.types import INF, f32
from .bvh import run_loop, stack_read, stack_write
from . import triangle as trimod

STACK_DEPTH = 64
MAX_PRIMS_PER_LEAF_TEST = 8


@dataclass
class KdTreeArrays:
    axis: torch.Tensor        # (M,) int64 split axis; 3 = leaf
    split: torch.Tensor       # (M,) float32 split position
    above: torch.Tensor       # (M,) int64 above child (below = i + 1)
    prim_start: torch.Tensor  # (M,) int64 into prim_ids (leaves)
    prim_count: torch.Tensor  # (M,) int64
    prim_ids: torch.Tensor    # (P,) int64 triangle ids (a triangle may repeat)
    bounds_min: torch.Tensor  # (3,) float32 world bounds
    bounds_max: torch.Tensor  # (3,)


COLUMNS = ("axis", "split", "above", "prim_start", "prim_count", "prim_ids",
           "bounds_min", "bounds_max")


def kd_from_numpy(arrs, device):
    """KdTreeArrays from numpy COLUMNS (the JAX package's fields)."""
    flt = ("split", "bounds_min", "bounds_max")
    return KdTreeArrays(*(torch.as_tensor(np.asarray(arrs[k]), device=device).to(
        torch.float32 if k in flt else torch.int64) for k in COLUMNS))


def build_kdtree(positions, indices, isect_cost=80.0, trav_cost=1.0,
                 empty_bonus=0.5, max_prims=4, max_depth=None, device=None):
    """SAH kd-tree build on the host over BoundEdge events
    (kdtreeaccel.rs:100-410 semantics), the JAX package's arrays exactly;
    KdTreeArrays on `device` (cuda unless told otherwise)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    t = len(indices)
    p0 = positions[indices[:, 0]]
    p1 = positions[indices[:, 1]]
    p2 = positions[indices[:, 2]]
    pmin = np.minimum(np.minimum(p0, p1), p2)
    pmax = np.maximum(np.maximum(p0, p1), p2)
    wmin = pmin.min(0) if t else np.zeros(3, np.float32)
    wmax = pmax.max(0) if t else np.ones(3, np.float32)
    if max_depth is None:
        max_depth = int(8 + 1.3 * np.log2(max(t, 1))) if t else 1

    axis_l, split_l, above_l, pstart_l, pcount_l = [], [], [], [], []
    prim_ids = []

    def new_node():
        axis_l.append(3)
        split_l.append(0.0)
        above_l.append(0)
        pstart_l.append(0)
        pcount_l.append(0)
        return len(axis_l) - 1

    def make_leaf(ni, ids):
        axis_l[ni] = 3
        pstart_l[ni] = len(prim_ids)
        pcount_l[ni] = len(ids)
        prim_ids.extend(ids)

    def build(ids, bmin, bmax, depth, bad_refines):
        ni = new_node()
        if len(ids) <= max_prims or (depth >= max_depth
                                     and len(ids) <= MAX_PRIMS_PER_LEAF_TEST):
            make_leaf(ni, ids)
            return ni
        if depth >= max_depth + 8:   # hard stop even if oversized
            make_leaf(ni, ids[:MAX_PRIMS_PER_LEAF_TEST * 4])
            return ni
        # SAH over edge events on the longest axes (retry order)
        d = bmax - bmin
        total_sa = 2 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])
        inv_sa = 1.0 / max(total_sa, 1e-12)
        old_cost = isect_cost * len(ids)
        best = None
        for ax in np.argsort(-d):
            lo = pmin[ids, ax]
            hi = pmax[ids, ax]
            # events: (pos, is_end)
            pos = np.concatenate([lo, hi])
            typ = np.concatenate([np.zeros(len(ids)), np.ones(len(ids))])
            order = np.lexsort((typ, pos))
            pos_s, typ_s = pos[order], typ[order]
            n_below, n_above = 0, len(ids)
            for k in range(len(pos_s)):
                if typ_s[k] == 1:
                    n_above -= 1
                p_split = pos_s[k]
                if bmin[ax] < p_split < bmax[ax]:
                    o = [0, 1, 2]
                    o.remove(ax)
                    a0, a1 = o
                    below_sa = 2 * (d[a0] * d[a1] + (p_split - bmin[ax]) * (d[a0] + d[a1]))
                    above_sa = 2 * (d[a0] * d[a1] + (bmax[ax] - p_split) * (d[a0] + d[a1]))
                    pb = below_sa * inv_sa
                    pa = above_sa * inv_sa
                    eb = empty_bonus if (n_above == 0 or n_below == 0) else 0.0
                    cost = trav_cost + isect_cost * (1 - eb) * (pb * n_below + pa * n_above)
                    if best is None or cost < best[0]:
                        best = (cost, ax, p_split)
                if typ_s[k] == 0:
                    n_below += 1
            if best is not None:
                break
        if best is None or (best[0] > 4 * old_cost and len(ids) < 16) or bad_refines == 3:
            if len(ids) > MAX_PRIMS_PER_LEAF_TEST:
                # oversized fallback leaf → spatial median split so the
                # bounded leaf-test unroll stays correct
                ax = int(np.argmax(d))
                p_split = float(np.median(0.5 * (pmin[ids, ax] + pmax[ids, ax])))
                if bmin[ax] < p_split < bmax[ax]:
                    best = (old_cost, ax, p_split)
                else:
                    make_leaf(ni, ids)
                    return ni
            else:
                make_leaf(ni, ids)
                return ni
        cost, ax, p_split = best
        if cost > old_cost:
            bad_refines += 1
        below_ids = [i for i in ids if pmin[i, ax] < p_split]
        above_ids = [i for i in ids if pmax[i, ax] > p_split]
        axis_l[ni] = int(ax)
        split_l[ni] = float(p_split)
        bmax_b = bmax.copy()
        bmax_b[ax] = p_split
        bmin_a = bmin.copy()
        bmin_a[ax] = p_split
        build(below_ids, bmin, bmax_b, depth + 1, bad_refines)
        above = build(above_ids, bmin_a, bmax, depth + 1, bad_refines)
        above_l[ni] = above
        return ni

    lim = sys.getrecursionlimit()
    sys.setrecursionlimit(max(lim, 10000))
    try:
        if t:
            build(list(range(t)), wmin.copy(), wmax.copy(), 0, 0)
        else:
            make_leaf(new_node(), [])
    finally:
        sys.setrecursionlimit(lim)

    return kd_from_numpy(dict(
        axis=np.array(axis_l, np.int32), split=np.array(split_l, np.float32),
        above=np.array(above_l, np.int32), prim_start=np.array(pstart_l, np.int32),
        prim_count=np.array(pcount_l, np.int32),
        prim_ids=np.array(prim_ids if prim_ids else [0], np.int32),
        bounds_min=wmin, bounds_max=wmax), resolve_device(device))


def traverse_closest(kd: KdTreeArrays, tri, o, d, t_min, t_max, return_steps=False):
    """Closest hit of rays o, d (N, 3) in (t_min, t_max) (N,) through the
    kd-tree, per-lane (node, t-range) stacks (kdtreeaccel.rs:419+). Returns
    (hit, t, tri_idx, b1, b2), and the steps run if asked."""
    n = o.shape[0]
    dev = o.device
    inv_d = 1.0 / torch.where(d.abs() < f32(1e-12),
                              torch.where(d < 0, f32(-1e-12), f32(1e-12)), d)
    t0w = (kd.bounds_min - o) * inv_d     # clipped to the world bounds
    t1w = (kd.bounds_max - o) * inv_d
    tn = torch.maximum(torch.minimum(t0w, t1w).amax(-1), t_min)
    tf = torch.minimum(torch.maximum(t0w, t1w).amin(-1), t_max)
    p0a, p1a, p2a = tri.corners()
    last = kd.prim_ids.shape[0] - 1
    zi = torch.zeros(n, dtype=torch.int64, device=dev)
    zf = torch.zeros(n, dtype=torch.float32, device=dev)
    st = lambda dt: torch.zeros((n, STACK_DEPTH), dtype=dt, device=dev)  # noqa: E731
    state = (torch.where(tn <= tf, 0, -1), tn, tf, zi, st(torch.int64), st(torch.float32),
             st(torch.float32), torch.broadcast_to(t_max, (n,)).to(torch.float32).clone(),
             zi, zf, zf, torch.zeros(n, dtype=torch.bool, device=dev))

    def step(s):
        cur, cur_tmin, cur_tmax, sp, st_node, st_tmin, st_tmax, best_t, best_i, b1, b2, hit = s
        ci = torch.clamp(cur, min=0)
        active = cur >= 0
        ax = kd.axis[ci]
        is_leaf = ax == 3
        start, count = kd.prim_start[ci], kd.prim_count[ci]
        for k in range(MAX_PRIMS_PER_LEAF_TEST):     # a leaf's first 8 triangles
            pid = kd.prim_ids[torch.clamp(start + k, 0, last)]
            h, tt, bb1, bb2 = trimod.moller_trumbore(o, d, p0a[pid], p1a[pid], p2a[pid],
                                                     t_min, best_t)
            take = active & is_leaf & (k < count) & h
            best_t = torch.where(take, tt, best_t)
            best_i = torch.where(take, pid, best_i)
            b1 = torch.where(take, bb1, b1)
            b2 = torch.where(take, bb2, b2)
            hit = hit | take
        axc = torch.clamp(ax, 0, 2)[:, None]
        oa = o.gather(1, axc)[:, 0]
        ia = inv_d.gather(1, axc)[:, 0]
        split = kd.split[ci]
        t_plane = (split - oa) * ia
        below_first = (oa < split) | ((oa == split) & (ia <= 0))
        first = torch.where(below_first, ci + 1, kd.above[ci])
        second = torch.where(below_first, kd.above[ci], ci + 1)
        # the plane behind (t_plane <= 0) or past the range: the first child only
        only_first = (t_plane > cur_tmax) | (t_plane <= 0)
        only_second = (t_plane < cur_tmin) & ~only_first
        push = active & ~is_leaf & ~only_first & ~only_second
        st_node = stack_write(st_node, sp, second, push)
        st_tmin = stack_write(st_tmin, sp, t_plane, push)
        st_tmax = stack_write(st_tmax, sp, cur_tmax, push)
        sp = sp + push.to(torch.int64)
        next_interior = torch.where(only_second, second, first)
        next_tmax = torch.where(push, torch.minimum(t_plane, cur_tmax), cur_tmax)
        next_tmin = torch.where(only_second, torch.maximum(t_plane, cur_tmin), cur_tmin)
        # at a leaf (tested): pop, without the early out on best_t < the
        # stack's tmin (as the JAX package: correct, slower)
        do_pop = active & is_leaf & (sp > 0)
        cur = torch.where(active & ~is_leaf, next_interior,
                          torch.where(do_pop, stack_read(st_node, sp - 1), -1))
        cur = torch.where(active, cur, -1)
        cur_tmin = torch.where(do_pop, stack_read(st_tmin, sp - 1), next_tmin)
        cur_tmax = torch.where(do_pop, stack_read(st_tmax, sp - 1), next_tmax)
        sp = torch.where(do_pop, sp - 1, sp)
        return (cur, cur_tmin, cur_tmax, sp, st_node, st_tmin, st_tmax, best_t, best_i, b1,
                b2, hit)

    s, steps = run_loop(step, state, lambda s: s[0] >= 0)
    best_t, best_i, b1, b2, hit = s[7:]
    out = (hit, torch.where(hit, best_t, INF), best_i, b1, b2)
    return (out, steps) if return_steps else out
