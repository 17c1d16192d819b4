"""Tile×cluster ray tracer (counterpart of pbrt_tpu/geom/cluster.py).

Triangles are grouped into K-slot clusters cut from the SAH BVH; rays are
sorted by a (direction octant, origin Morton, direction Morton) key into
tiles of TILE lanes; the coverage kernel finds, per tile, which clusters
each lane enters and at what entry t; the closest-hit and any-hit kernels
walk each tile's clusters in ascending entry t. The kernels live in
kernels/cluster_cuda.py; this module builds the clusters, sorts and pads
the rays, orders each tile's cluster list and puts the results back in
lane order.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.types import INF, f32
from ..kernels import cluster_cuda as kern
from . import native_build

TILE = 1024            # rays per tile on the card
TRAV_CAP = 4096        # longest per-tile cluster list the traversal takes
NF = kern.NF
_KEY_OBITS = 5         # origin Morton bits per axis
_KEY_DBITS = 4         # direction Morton bits per axis
_DEAD_KEY = 0xFFFFFFFF


@dataclass
class ClusterSet:
    packed: torch.Tensor      # (C, 24, K) f32 Plücker/plane features
    bounds: torch.Tensor      # (6, CPAD) f32 lo/hi per axis, pad columns 0
    c_tri_id: torch.Tensor    # (C, K) int64 original triangle id (pad: first slot's)
    world_min: torch.Tensor   # (3,) f32
    world_max: torch.Tensor   # (3,) f32

    @property
    def n_clusters(self):
        return self.packed.shape[0]

    @property
    def cluster_size(self):
        return self.packed.shape[2]


def treelet_groups(rp, nn, t, k, unit=None):
    """Cut the depth-first BVH into contiguous prim ranges of whole
    subtrees with <= `unit` prims, then greedily pack consecutive ranges
    into clusters of <= k. Returns [(start, count)] covering [0, t)."""
    if unit is None:
        unit = max(k // 4, 16)
    m = len(nn)
    count = np.zeros(m, np.int64)
    start = np.zeros(m, np.int64)
    for i in range(m - 1, -1, -1):      # children have larger indices
        if nn[i] > 0:
            count[i] = nn[i]
            start[i] = rp[i]
        else:
            count[i] = count[i + 1] + count[rp[i]]
            start[i] = start[i + 1]
    units = []
    stack = [0]
    while stack:
        i = stack.pop()
        if nn[i] > 0 or count[i] <= unit:
            units.append((int(start[i]), int(count[i])))
        else:
            stack.append(int(rp[i]))
            stack.append(i + 1)
    groups = []
    cur_s, cur_c = units[0]
    for s, cnt in units[1:]:
        if cur_c + cnt <= k:
            cur_c += cnt
        else:
            groups.append((cur_s, cur_c))
            cur_s, cur_c = s, cnt
    groups.append((cur_s, cur_c))
    if sum(c for _, c in groups) != t:
        raise RuntimeError("treelet cut does not cover every triangle")
    return groups


def build_clusters_np(positions, indices, k=128):
    """Host-side cluster build; returns a dict of numpy arrays (packed,
    bounds, c_tri_id, world_min, world_max). Padding slots carry
    degenerate triangles (zero normal: never hit)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32).reshape(-1, 3)
    t = len(indices)
    pa, pb, pc = (positions[indices[:, i]] for i in range(3))
    res = native_build.build_bvh_sah(np.minimum(np.minimum(pa, pb), pc),
                                     np.maximum(np.maximum(pa, pb), pc), 4)
    prim_order = res[5]
    groups = treelet_groups(res[2], res[3], t, k)
    c = len(groups)
    slots = np.zeros((c, k), np.int64)
    valid = np.zeros((c, k), bool)
    for ci, (s, cnt) in enumerate(groups):
        slots[ci, :cnt] = np.arange(s, s + cnt)
        slots[ci, cnt:] = s
        valid[ci, :cnt] = True
    order = prim_order[slots.reshape(-1)]
    valid = valid.reshape(-1)
    idx = indices[order]
    p0 = positions[idx[:, 0]].astype(np.float64)
    p1 = positions[idx[:, 1]].astype(np.float64)
    p2 = positions[idx[:, 2]].astype(np.float64)
    p1[~valid] = p0[~valid]
    p2[~valid] = p0[~valid]
    u0, v0 = np.cross(p0, p1), p1 - p0
    u1, v1 = np.cross(p1, p2), p2 - p1
    u2, v2 = np.cross(p2, p0), p0 - p2
    n = np.cross(p1 - p0, p2 - p0)
    kplane = np.sum(n * p0, axis=-1)
    packed = np.concatenate([u0, v0, u1, v1, u2, v2, n, kplane[:, None],
                             np.zeros((len(p0), 2))], axis=1).astype(np.float32)
    packed = packed.reshape(c, k, NF).transpose(0, 2, 1)
    p0f = p0.astype(np.float32).reshape(c, k, 3)
    p1f = p1.astype(np.float32).reshape(c, k, 3)
    p2f = p2.astype(np.float32).reshape(c, k, 3)
    bmin = np.minimum(np.minimum(p0f.min(1), p1f.min(1)), p2f.min(1))
    bmax = np.maximum(np.maximum(p0f.max(1), p1f.max(1)), p2f.max(1))
    cpad = -(-c // kern.COV_CLUSTERS) * kern.COV_CLUSTERS
    bounds = np.zeros((6, cpad), np.float32)
    for ax in range(3):
        bounds[2 * ax, :c] = bmin[:, ax]
        bounds[2 * ax + 1, :c] = bmax[:, ax]
    return dict(packed=np.ascontiguousarray(packed), bounds=bounds,
                c_tri_id=order.reshape(c, k).astype(np.int64),
                world_min=bmin.min(0), world_max=bmax.max(0))


def cluster_set_from_numpy(arrs, device):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    return ClusterSet(packed=t(arrs["packed"]).to(torch.float32),
                      bounds=t(arrs["bounds"]).to(torch.float32),
                      c_tri_id=t(arrs["c_tri_id"]).to(torch.int64),
                      world_min=t(arrs["world_min"]).to(torch.float32),
                      world_max=t(arrs["world_max"]).to(torch.float32))


def build_clusters(positions, indices, device, k=128):
    return cluster_set_from_numpy(build_clusters_np(positions, indices, k), device)


# -------------------------------------------------------- ray coherence

def _expand_bits10(v):
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton3(q, bits):
    qi = (torch.clamp(q, 0.0, 1.0) * f32((1 << bits) - 1)).to(torch.int64)
    m = (_expand_bits10(qi[..., 0]) | (_expand_bits10(qi[..., 1]) << 1)
         | (_expand_bits10(qi[..., 2]) << 2))
    return m & ((1 << (3 * bits)) - 1)


def coherence_key(cs: ClusterSet, o, d):
    """Sort key (uint32 values in int64): direction octant, coarse origin
    Morton, then direction Morton."""
    octant = ((d[..., 0] < 0).to(torch.int64) | ((d[..., 1] < 0).to(torch.int64) << 1)
              | ((d[..., 2] < 0).to(torch.int64) << 2))
    ext = torch.clamp(cs.world_max - cs.world_min, min=f32(1e-6))
    m_origin = _morton3((o - cs.world_min) / ext, _KEY_OBITS)
    m_dir = _morton3(0.5 * (d + 1.0), _KEY_DBITS)
    return ((octant << (3 * (_KEY_OBITS + _KEY_DBITS)))
            | (m_origin << (3 * _KEY_DBITS)) | m_dir)


def world_exit_cap(cs: ClusterSet, o, d, t_min, t_max):
    """min(t_max, exit t from the cluster set's AABB): a finite best t
    lets the ordered-entry-t pruning fire; rays missing the box die."""
    dd = torch.where(d.abs() < f32(1e-12),
                     torch.where(d < 0, f32(-1e-12), f32(1e-12)), d)
    inv = 1.0 / dd
    t0 = (cs.world_min - o) * inv
    t1 = (cs.world_max - o) * inv
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    miss = (tn > tf * f32(1.0001)) | (tf < t_min)
    cap = tf * f32(1.0005) + f32(1e-4)
    return torch.where(miss, t_min - 1.0, torch.minimum(t_max, cap))


def prepare(cs: ClusterSet, o, d, t_min, t_max, tile, flag=None):
    """Sort lanes by coherence key (dead lanes last) and pad to whole
    tiles. Returns (order (n,), rays (8, npad) f32, flag (npad,) or None).
    Padding lanes copy lane 0 with t_max = -1 (inert)."""
    n = o.shape[0]
    t_max = world_exit_cap(cs, o, d, t_min, t_max)
    key = coherence_key(cs, o, d)
    key = torch.where(t_max > t_min, key, _DEAD_KEY)
    order = torch.argsort(key, stable=True)
    pad = (-n) % tile
    order_p = torch.cat([order, torch.zeros(pad, dtype=order.dtype, device=o.device)])
    rec = torch.cat([o.T, d.T, t_min[None], t_max[None]]
                    + ([flag[None].to(torch.float32)] if flag is not None else []))
    rec_s = rec[:, order_p]
    rays = rec_s[:8].contiguous()
    rays[7, n:] = -1.0
    flag_s = rec_s[8].contiguous() if flag is not None else None
    return order, rays, flag_s


def tile_cluster_order(cs: ClusterSet, rays, tile):
    """Coverage pass plus each tile's cluster list in ascending entry t.
    Returns (corder (nt, W) i32, tnear (nt, W) f32, counts (nt,) i32,
    covbits)."""
    c = cs.n_clusters
    n_live = (rays[7] > rays[6]).sum()
    n_live_tiles = torch.div(n_live + tile - 1, tile, rounding_mode="floor")
    tnear, covbits = kern.coverage(rays, cs.bounds,
                                   n_live_tiles.to(torch.int32).reshape(1), c, tile)
    counts = (tnear < INF).sum(1)
    corder = torch.argsort(tnear, dim=1, stable=True)
    tnear_s = torch.gather(tnear, 1, corder)
    # positions past `counts` may name pad columns: point them at a real
    # cluster (a redundant exact test is harmless)
    corder = torch.clamp(corder, max=c - 1)
    cap = -(-TRAV_CAP // kern.CH) * kern.CH
    if cap < corder.shape[1]:
        corder = corder[:, :cap]
        tnear_s = tnear_s[:, :cap]
        counts = torch.clamp(counts, max=cap)
    return (corder.to(torch.int32).contiguous(), tnear_s.contiguous(),
            counts.to(torch.int32), covbits)


def _un(order, n, a):
    """A sorted, padded kernel output back to lane order (n,)."""
    out = torch.empty((n,), dtype=a.dtype, device=a.device)
    out[order] = a.reshape(-1)[:n]
    return out


def _unsort(cs, order, n, t, slot, bary):
    """Sorted kernel outputs back to lane order: (hit, t, tri_idx, b1, b2)."""
    un = lambda a: _un(order, n, a)   # noqa: E731
    s = un(slot).to(torch.int64)
    hit = s >= 0
    tid = cs.c_tri_id.reshape(-1)[torch.clamp(s, min=0)]
    return (hit, torch.where(hit, un(t), INF), tid, un(bary[:, 0]), un(bary[:, 1]))


def _trace(cs, o, d, t_min, t_max, tile, flag=None):
    order, rays, flag_s = prepare(cs, o, d, t_min, t_max, tile, flag)
    corder, tnear, counts, covbits = tile_cluster_order(cs, rays, tile)
    t, slot, bary = kern.closest(cs.packed, rays, flag_s, corder, tnear, counts,
                                 covbits, tile)
    return _unsort(cs, order, o.shape[0], t, slot, bary)


def intersect(cs: ClusterSet, o, d, t_min, t_max, tile=TILE):
    """Closest hit for rays o, d (N, 3). Returns (hit, t, tri_idx, b1, b2)."""
    return _trace(cs, o, d, t_min, t_max, tile)


def intersect_occluded(cs: ClusterSet, o, d, t_min, t_max, o_sh, d_sh, tmin_sh,
                       tmax_sh, tile=TILE):
    """Fused closest hit (o, d) and any hit (o_sh, d_sh): one sort, one
    coverage pass, one closest-hit launch, shadow lanes in any-hit mode.
    Returns ((hit, t, tri_idx, b1, b2), occ)."""
    n, n_sh = o.shape[0], o_sh.shape[0]
    flag = torch.cat([torch.zeros(n, device=o.device), torch.ones(n_sh, device=o.device)])
    hit, t, tid, b1, b2 = _trace(cs, torch.cat([o, o_sh]), torch.cat([d, d_sh]),
                                 torch.cat([t_min, tmin_sh]),
                                 torch.cat([t_max, tmax_sh]), tile, flag)
    return (hit[:n], t[:n], tid[:n], b1[:n], b2[:n]), hit[n:]


def occluded(cs: ClusterSet, o, d, t_min, t_max, tile=TILE):
    """Any hit for rays o, d (N, 3): occ (N,) bool, true where a triangle
    lies at t_min < t < t_max (counterpart of occluded_pallas)."""
    order, rays, _ = prepare(cs, o, d, t_min, t_max, tile)
    corder, tnear, counts, covbits = tile_cluster_order(cs, rays, tile)
    occ = kern.occluded(cs.packed, rays, corder, tnear, counts, covbits, tile)
    return _un(order, o.shape[0], occ)
