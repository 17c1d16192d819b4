"""The tracer kernels' roofline, counted by the benchmark's own frozen
code from what crosses the boundary of the port's geom/cluster.py: the
rays handed to `_trace` (closest hit, with fused any-hit lanes where a
flag is given) and to `occluded` (any hit), the hits returned, and the
cluster boxes and slot counts of the ClusterSet. The count does not
depend on how a kernel walks the clusters.

Work a lane needs:
  closest hit  the real triangles of every cluster whose box the ray
               enters at or before its returned hit (t_max on a miss),
               49 float32 operations each;
  any hit      an unoccluded ray: every cluster it enters within its
               window; an occluded one: the cluster it enters first
               (the least any walk can test), 51 operations a triangle.
Bytes: each live lane's ray (o, d, t_min, t_max: 32 bytes, 36 with the
flag) read once, the features (NF float32 a slot) of every cluster some
lane needs read once, and each live lane's result written once (16 bytes
for a closest hit, 1 for an any hit). The least time is the larger of
ops / F32_FLOPS and bytes / HBM_BYTES."""
from __future__ import annotations

import contextlib

import torch

from . import peaks

OPS_CLOSEST = 49
OPS_ANY = 51
LANES = 32768


class Capture:
    """Records the tracer boundary's calls while `active()` is entered."""

    def __init__(self, clmod):
        self.clmod = clmod
        self.calls = []       # (kind, cs, o, d, t_min, t_max, flag, hit, t)

    @contextlib.contextmanager
    def active(self):
        cl = self.clmod
        trace0, occluded0 = cl._trace, cl.occluded

        def trace(cs, o, d, t_min, t_max, tile, flag=None):
            res = trace0(cs, o, d, t_min, t_max, tile, flag)
            self.calls.append(("closest", cs, o, d, t_min, t_max, flag, res[0], res[1]))
            return res

        def occluded(cs, o, d, t_min, t_max, tile=cl.TILE):
            occ = occluded0(cs, o, d, t_min, t_max, tile)
            self.calls.append(("occluded", cs, o, d, t_min, t_max, None, occ, None))
            return occ

        cl._trace, cl.occluded = trace, occluded
        try:
            yield self
        finally:
            cl._trace, cl.occluded = trace0, occluded0


def _slab(lo, hi, o, d, t_min, t_max):
    """(b, C) entry t and entered mask of rays against boxes lo, hi (C, 3)."""
    dd = torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
    inv = 1.0 / dd
    a = (lo[None] - o[:, None]) * inv[:, None]
    b = (hi[None] - o[:, None]) * inv[:, None]
    tn = torch.maximum(torch.minimum(a, b).amax(-1), t_min[:, None])
    tf = torch.minimum(torch.maximum(a, b).amin(-1), t_max[:, None])
    return tn, tn <= tf


@torch.no_grad()
def work(call):
    """(ops, bytes) that one captured call needs."""
    kind, cs, o, d, t_min, t_max, flag, hit, t = call
    c = cs.n_clusters
    lo = torch.stack([cs.bounds[0, :c], cs.bounds[2, :c], cs.bounds[4, :c]], 1)
    hi = torch.stack([cs.bounds[1, :c], cs.bounds[3, :c], cs.bounds[5, :c]], 1)
    nf = cs.packed.shape[1]
    ntri = (cs.packed[:, 18:21, :] != 0).any(1).sum(1).to(torch.float64)   # real slots
    anyhit = (torch.zeros_like(t_max, dtype=torch.bool) if kind == "closest" and flag is None
              else torch.ones_like(t_max, dtype=torch.bool) if kind == "occluded"
              else flag > 0.5)
    t_end = t_max if kind == "occluded" else torch.where(hit & ~anyhit, t, t_max)
    live = t_max > t_min
    ops = 0.0
    used = torch.zeros(c, dtype=torch.bool, device=o.device)
    for s in range(0, o.shape[0], LANES):
        sl = slice(s, s + LANES)
        tn, ent = _slab(lo, hi, o[sl], d[sl], t_min[sl], t_end[sl])
        ent &= live[sl, None]
        first = torch.where(ent, tn, float("inf")).argmin(1)
        occ_any = anyhit[sl] & hit[sl]
        need = torch.where(occ_any[:, None],
                           torch.nn.functional.one_hot(first, c).bool() & ent, ent)
        tris = need.to(torch.float64) @ ntri
        ops += float(OPS_CLOSEST * tris[~anyhit[sl]].sum() + OPS_ANY * tris[anyhit[sl]].sum())
        used |= need.any(0)
    n_live = float(live.sum())
    n_any = float((live & anyhit).sum())
    ray_bytes = 36 if flag is not None else 32
    out_bytes = 1 if kind == "occluded" else 16
    nbytes = (n_live * ray_bytes + float(used.sum()) * nf * cs.packed.shape[2] * 4
              + n_live * out_bytes)
    return ops, nbytes, n_any


def least_seconds(ops, nbytes):
    """(least time, the bound that sets it)."""
    t_ops, t_mem = ops / peaks.F32_FLOPS, nbytes / peaks.HBM_BYTES
    return (t_ops, "ops") if t_ops >= t_mem else (t_mem, "bytes")


def summarize(capture, kind):
    """Least seconds, ops and bytes summed over the captured calls of `kind`,
    and which bound sets the sum (None when there were none)."""
    calls = [c for c in capture.calls if c[0] == kind]
    if not calls:
        return None
    ops = nbytes = least = 0.0
    for c in calls:
        o, b, _ = work(c)
        ops, nbytes = ops + o, nbytes + b
        least += least_seconds(o, b)[0]
    return {"least_s": least, "ops": ops, "bytes": nbytes,
            "bound": least_seconds(ops, nbytes)[1], "calls": len(calls)}


def add(a, b):
    """Two summaries added (either may be None)."""
    if a is None or b is None:
        return a or b
    out = {k: a[k] + b[k] for k in ("least_s", "ops", "bytes", "calls")}
    out["bound"] = least_seconds(out["ops"], out["bytes"])[1]
    return out
