"""Instanced and animated primitives (counterpart of
pbrt_tpu/geom/instances.py; TransformedPrimitive, primitive.rs:105-177, and
AnimatedTransform's interpolation, transform.rs:2010).

A prototype mesh is stored once. Each instance carries a rigid motion,
decomposed on the host into a translation, a rotation quaternion (w, x, y,
z) and a static linear part S, and interpolated per ray at the lane's
shutter time: the translation lerped, the quaternion slerped. Rays go into
object space without renormalising the direction, so a hit's t is the
world t; normals come back through the inverse transpose.

The wavefront form (geom/scene.py calls `trace`): one slab test of every
(instance, lane) against the instances' conservative world boxes gives a
mask, compacted once (one nonzero, one host sync a set and trace) into
(instance, lane) pairs; each pair's ray goes into its instance's object
space, and all pairs of a set, closest-hit and shadow rays together, trace
as one object-space wavefront through the prototype's cluster set (the
CUDA kernels on the card) or the brute-force tracers. Each lane then keeps its
pair of least (t, instance index): the JAX package's instance loop merges
with a strict <, so an earlier instance wins a tie.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core import vecmath as vm
from ..core.types import f32
from . import cluster as clmod
from . import triangle as trimod
from .types import TriangleSoA

# the InstanceSet's per-instance columns and their dtypes (None: float32)
COLUMNS = (("q0", None), ("q1", None), ("t0", None), ("t1", None), ("lin", None),
           ("lin_inv", None), ("material_id", torch.int64), ("bmin", None),
           ("bmax", None), ("light_id", torch.int64))
_NO_PAIR = (1 << 63) - 1     # reduction key of a lane no pair hit


@dataclass
class InstanceSet:
    proto: TriangleSoA         # the prototype, one copy, object space
    q0: torch.Tensor           # (I, 4) rotation at shutter open (w, x, y, z)
    q1: torch.Tensor           # (I, 4) at shutter close (the shorter arc from q0)
    t0: torch.Tensor           # (I, 3) translation at open
    t1: torch.Tensor           # (I, 3) at close
    lin: torch.Tensor          # (I, 3, 3) static linear part S (applied first)
    lin_inv: torch.Tensor      # (I, 3, 3)
    material_id: torch.Tensor  # (I,) int64
    bmin: torch.Tensor         # (I, 3) conservative world box over the shutter
    bmax: torch.Tensor         # (I, 3)
    light_id: torch.Tensor     # (I,) int64 area-light id or -1
    animated: bool = False     # any instance moves over the shutter
    clusters: Optional[clmod.ClusterSet] = None   # the prototype's, or brute force

    @property
    def count(self):
        return self.q0.shape[0]


# ------------------------------------------------------------ host build

def _polar_rotation(m):
    """Rotation factor of a 3x3 by Higham's iteration (float64)."""
    r = m.astype(np.float64)
    for _ in range(32):
        r_next = 0.5 * (r + np.linalg.inv(r.T))
        if np.max(np.abs(r_next - r)) < 1e-12:
            r = r_next
            break
        r = r_next
    return r


def _mat_to_quat(r):
    """Rotation matrix → quaternion (w, x, y, z)."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (r[2, 1] - r[1, 2]) / s,
                         (r[0, 2] - r[2, 0]) / s, (r[1, 0] - r[0, 1]) / s])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _decompose(m):
    """4x4 → (quaternion, translation, linear S) with M[:3, :3] = R @ S."""
    m = np.asarray(m, np.float64)
    t = m[:3, 3]
    r = _polar_rotation(m[:3, :3])
    s = r.T @ m[:3, :3]
    return _mat_to_quat(r), t, s


def _aabb_corners(lo, hi):
    return np.array([[x, y, z] for x in (lo[0], hi[0])
                     for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])


def quat_rotation_np(q):
    """3x3 rotation of the quaternion q = (w, x, y, z), in q's dtype."""
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def build_instances_np(proto_positions, transforms, materials, transforms1=None,
                       light_ids=None):
    """The set's columns on the host, as the JAX package's build_instances
    computes them: float64 quaternions, translations and linear parts (the
    close quaternion flipped onto the shorter arc), boxes from the
    prototype's box corners through the transforms at 5 shutter times (1
    for a static instance) padded by 5% (1e-5 static) and 1e-5, and
    "animated". Raises for a linear part that changes over the shutter."""
    n = len(transforms)
    transforms1 = transforms if transforms1 is None else transforms1
    q0, q1 = np.zeros((n, 4)), np.zeros((n, 4))
    t0, t1 = np.zeros((n, 3)), np.zeros((n, 3))
    lin = np.zeros((n, 3, 3))
    for i in range(n):
        qa, ta, sa = _decompose(transforms[i])
        qb, tb, sb = _decompose(transforms1[i])
        if np.dot(qa, qb) < 0:        # the shorter arc (quaternion.rs:31)
            qb = -qb
        q0[i], t0[i], lin[i] = qa, ta, sa
        q1[i], t1[i] = qb, tb
        if not np.allclose(sa, sb, atol=1e-5):
            raise ValueError("animated scale/shear is not supported; "
                             "keep the linear part constant over the shutter")
    animated = bool(np.any(np.abs(q0 - q1) > 1e-7) or np.any(np.abs(t0 - t1) > 1e-7))
    pos = np.asarray(proto_positions) if len(proto_positions) else np.zeros((1, 3))
    corners = _aabb_corners(pos.min(0), pos.max(0))
    bmin, bmax = np.zeros((n, 3)), np.zeros((n, 3))
    for i in range(n):
        pts = []
        n_times = 5 if (np.any(np.abs(q0[i] - q1[i]) > 1e-7)
                        or np.any(np.abs(t0[i] - t1[i]) > 1e-7)) else 1
        for u in np.linspace(0.0, 1.0, max(n_times, 1)):
            d01 = float(np.clip(np.dot(q0[i], q1[i]), -1.0, 1.0))
            th = np.arccos(abs(d01))
            if th < 1e-6 or n_times == 1:
                q = q0[i]
            else:
                q = (np.sin((1 - u) * th) * q0[i] + np.sin(u * th) * q1[i]) / np.sin(th)
            q = q / np.linalg.norm(q)
            t = (1 - u) * t0[i] + u * t1[i]
            pts.append(corners @ (quat_rotation_np(q) @ lin[i]).T + t)
        allp = np.concatenate(pts, 0)
        c = (allp.min(0) + allp.max(0)) / 2
        half = (allp.max(0) - allp.min(0)) / 2
        pad = 0.05 if n_times > 1 else 1e-5
        bmin[i] = c - half * (1 + pad) - 1e-5
        bmax[i] = c + half * (1 + pad) + 1e-5
    return dict(q0=q0, q1=q1, t0=t0, t1=t1, lin=lin, lin_inv=np.linalg.inv(lin),
                material_id=np.asarray(materials, np.int32), bmin=bmin, bmax=bmax,
                light_id=(np.full(n, -1, np.int32) if light_ids is None
                          else np.asarray(light_ids, np.int32)),
                animated=animated)


def instances_from_numpy(proto, arrs, device, clusters=None):
    """InstanceSet of the prototype TriangleSoA `proto` (shading record
    built) from numpy columns laid out as the JAX package's InstanceSet
    (COLUMNS and "animated"), each cast to float32 or int64 on `device`."""
    t = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(  # noqa: E731
        torch.float32 if dt is None else dt)
    return InstanceSet(proto=proto, **{k: t(arrs[k], dt) for k, dt in COLUMNS},
                       animated=bool(arrs["animated"]), clusters=clusters)


def build_instances(proto, transforms, materials, transforms1=None, light_ids=None,
                    clusters=False):
    """InstanceSet of prototype `proto` (a TriangleSoA with its shading
    record) under 4x4 object→world `transforms` at shutter open and
    `transforms1` at close (None: static); `materials` and `light_ids` per
    instance. With `clusters` the prototype's cluster set is built, and
    its object-space wavefronts run through the cluster tracer."""
    pos = proto.positions.cpu().numpy()
    arrs = build_instances_np(pos if proto.count else np.zeros((0, 3), np.float32),
                              transforms, materials, transforms1, light_ids)
    dev = proto.positions.device
    cs = clmod.build_clusters(pos, proto.indices.cpu().numpy(), dev) \
        if clusters and proto.count else None
    return instances_from_numpy(proto, arrs, dev, cs)


# --------------------------------------------------------- ray transforms

def _slerp(q0, q1, u):
    """Slerp of (w, x, y, z) quaternions per lane (quaternion.rs:31);
    linear where sin θ < 1e-4."""
    d = torch.clamp((q0 * q1).sum(-1), -1.0, 1.0)
    theta = torch.acos(d)
    s = torch.sin(theta)
    near = s < f32(1e-4)
    s_ = torch.clamp(s, min=f32(1e-9))
    w0 = torch.where(near, 1.0 - u, torch.sin((1.0 - u) * theta) / s_)
    w1 = torch.where(near, u, torch.sin(u * theta) / s_)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / torch.sqrt((q * q).sum(-1, keepdim=True))


def _qrot(q, v):
    """v (N, 3) rotated by q (N, 4) (w, x, y, z)."""
    u, w = q[..., 1:4], q[..., 0:1]
    c = vm.cross(u, v)
    return v + 2.0 * (w * c + vm.cross(u, c))


def _qrot_inv(q, v):
    """v rotated by q's conjugate: _qrot with u negated, on the card's
    tensors alone."""
    u, w = q[..., 1:4], q[..., 0:1]
    c = vm.cross(v, u)
    return v + 2.0 * (w * c - vm.cross(u, c))


def _apply(m, v):
    """(N, 3, 3) matrices applied to vectors (N, 3)."""
    return (m * v[:, None, :]).sum(-1)


def frames(iset, inst, time):
    """(q, translation) of instances `inst` (P,) at per-pair shutter times
    `time` (P,), or at shutter open for None or a static set."""
    if time is None or not iset.animated:
        return iset.q0[inst], iset.t0[inst]
    u = torch.clamp(time, 0.0, 1.0)
    q = _slerp(iset.q0[inst], iset.q1[inst], u)
    return q, (1.0 - u)[..., None] * iset.t0[inst] + u[..., None] * iset.t1[inst]


def to_object(iset, inst, o, d, q, tr):
    """World rays → the instances' object space; the direction is not
    renormalised, so t carries over (primitive.rs:130-148)."""
    li = iset.lin_inv[inst]
    return _apply(li, _qrot_inv(q, o - tr)), _apply(li, _qrot_inv(q, d))


def entered(iset, o, d, t_min, t_max):
    """(I, N) mask: the ray's window (t_min, t_max) enters instance i's
    world box (the slab pre-cull; bvh.rs:842's bound test), in chunks of
    instances of at most 2^24 pairs."""
    inv = 1.0 / torch.where(d.abs() < f32(1e-12),
                            torch.where(d < 0, f32(-1e-12), f32(1e-12)), d)
    step = max(1, (1 << 24) // max(o.shape[0], 1))
    out = []
    for s in range(0, iset.count, step):
        tn = tf = None
        for ax in range(3):
            a = (iset.bmin[s:s + step, ax, None] - o[:, ax]) * inv[:, ax]
            b = (iset.bmax[s:s + step, ax, None] - o[:, ax]) * inv[:, ax]
            lo, hi = torch.minimum(a, b), torch.maximum(a, b)
            tn = lo if tn is None else torch.maximum(tn, lo)
            tf = hi if tf is None else torch.minimum(tf, hi)
        tf = tf * f32(1.0001)
        out.append((tn <= tf) & (tf >= t_min) & (tn <= t_max))
    return torch.cat(out)


def pairs(iset, o, d, t_min, t_max):
    """(instance, lane) index pairs whose window enters the instance's box,
    instance-major (so, for one lane, in instance order): one nonzero."""
    return entered(iset, o, d, t_min, t_max).nonzero(as_tuple=True)


# ------------------------------------------------------------- the trace

def trace(iset, rays, shadow, time, tile):
    """The set's closest hits of `rays` and any hits of `shadow` (each (o,
    d, t_min, t_max) on (N,) lanes, detached, or None); `time` (N,) the
    lanes' shutter times or None (shadow lane i takes time[i]). Both ray
    sets go through one pre-cull and one compaction into (instance, lane)
    pairs, and trace as one object-space wavefront of the prototype's
    cluster set (shadow pairs in any-hit mode; the any-hit kernel alone
    when there are no closest rays) or by brute force. Returns (closest,
    occ): closest None or (found, t, p, ng, ns, uv, dpdu, uv_scale,
    prim_id, material_id, light_id) per lane, the lane's pair of least (t,
    instance) with world-space shading (p = o + t d); occ None or (N_shadow,)
    bool."""
    parts = [r for r in (rays, shadow) if r is not None]
    nc = 0 if rays is None else rays[0].shape[0]
    o, d, t_min, t_max = (torch.cat(c) for c in zip(*parts))
    inst, lane = pairs(iset, o, d, t_min, t_max)
    if inst.numel() == 0:
        return None, None
    is_sh = lane >= nc
    if time is not None:
        time = time[torch.where(is_sh, lane - nc, lane)]
    q, tr = frames(iset, inst, time)
    o_l, d_l = to_object(iset, inst, o[lane], d[lane], q, tr)
    w = (o_l, d_l, t_min[lane], t_max[lane])
    cs = iset.clusters
    if cs is None:       # a shadow pair's closest hit in its window is its occlusion
        res = trimod.intersect_brute(iset.proto, *w)
    elif rays is None:
        res = (clmod.occluded(cs, *w, tile),)
    else:
        res = clmod.intersect_flagged(cs, *w, is_sh if shadow is not None else None, tile)
    occ = None
    if shadow is not None:
        occ = torch.zeros(shadow[0].shape[0], dtype=torch.int32, device=o.device)
        occ = occ.index_add_(0, torch.where(is_sh, lane - nc, 0),
                             (res[0] & is_sh).to(torch.int32)) > 0
    return (_closest(iset, rays, inst, torch.where(is_sh, 0, lane), ~is_sh, q, res)
            if rays is not None else None), occ


def _closest(iset, rays, inst, lane, is_c, q, res):
    """Each lane's closest pair (is_c) of least (t, pair index) — pairs are
    instance-major, so of least (t, instance) — and its world shading."""
    o, d = rays[0], rays[1]
    h, t, idx, b1, b2 = res
    # t > t_min >= 0 on a hit: its float bits order as the values do
    key = torch.where(h & is_c, (t.view(torch.int32).to(torch.int64) << 32)
                      | torch.arange(t.shape[0], device=t.device), _NO_PAIR)
    best = torch.full((o.shape[0],), _NO_PAIR, dtype=torch.int64, device=o.device)
    best = best.scatter_reduce(0, lane, key, "amin")
    found = best != _NO_PAIR
    pi = torch.where(found, best & 0xFFFFFFFF, 0)
    i_l, q_l, t_l = inst[pi], q[pi], t[pi]
    _, ng, ns, uv, dpdu, uvs, _, _ = trimod.shading_from_rec(iset.proto, idx[pi], b1[pi],
                                                             b2[pi])
    lin_it = iset.lin_inv[i_l].transpose(-1, -2)
    return (found, t_l, o + t_l[..., None] * d,
            vm.normalize(_qrot(q_l, _apply(lin_it, ng))),
            vm.normalize(_qrot(q_l, _apply(lin_it, ns))), uv,
            vm.normalize(_qrot(q_l, _apply(iset.lin[i_l], dpdu))), uvs, idx[pi],
            iset.material_id[i_l], iset.light_id[i_l])
