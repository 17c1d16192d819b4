"""Triangle and quadric pools and the hit record (counterpart of
pbrt_tpu/geom/types.py)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class TriangleSoA:
    """All scene triangles in world space."""
    positions: torch.Tensor     # (V, 3) float32
    indices: torch.Tensor       # (T, 3) int64
    normals: torch.Tensor       # (V, 3)
    uvs: torch.Tensor           # (V, 2)
    has_normals: torch.Tensor   # (T,) bool
    material_id: torch.Tensor   # (T,) int64
    light_id: torch.Tensor      # (T,) int64, -1 = not emissive
    # packed per-triangle shading record, one row gather per hit:
    # 0:9 p0 p1 p2 | 9:15 uv0 uv1 uv2 | 15:24 n0 n1 n2 | 24 has_ns |
    # 25 material_id | 26 light_id | 27 pad
    shade_rec: Optional[torch.Tensor] = None

    @property
    def count(self):
        return self.indices.shape[0]

    def corners(self):
        i = self.indices
        return self.positions[i[:, 0]], self.positions[i[:, 1]], self.positions[i[:, 2]]


def shade_record_np(pos, idx, nrm, uvs, has_ns, mat, light):
    """The (T, 28) float32 shading record, built on the host."""
    rec = np.zeros((idx.shape[0], 28), np.float32)
    for c in range(3):
        rec[:, 3 * c:3 * c + 3] = pos[idx[:, c]]
        rec[:, 9 + 2 * c:11 + 2 * c] = uvs[idx[:, c]]
        rec[:, 15 + 3 * c:18 + 3 * c] = nrm[idx[:, c]]
    rec[:, 24] = has_ns.astype(np.float32)
    rec[:, 25] = mat.astype(np.float32)
    rec[:, 26] = light.astype(np.float32)
    return rec


def triangles_from_numpy(pos, idx, nrm, uvs, has_ns, mat, light, device):
    pos = np.asarray(pos, np.float32)
    idx = np.asarray(idx, np.int64).reshape(-1, 3)
    nrm = np.asarray(nrm, np.float32)
    uvs = np.asarray(uvs, np.float32)
    has_ns = np.asarray(has_ns, bool)
    mat = np.asarray(mat, np.int64)
    light = np.asarray(light, np.int64)
    rec = shade_record_np(pos, idx, nrm, uvs, has_ns, mat, light)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return TriangleSoA(t(pos), t(idx), t(nrm), t(uvs), t(has_ns), t(mat),
                       t(light), t(rec))


QUAD_SPHERE = 0
QUAD_DISK = 1
QUAD_CYLINDER = 2
QUAD_CONE = 3
QUAD_PARABOLOID = 4
QUAD_HYPERBOLOID = 5


@dataclass
class QuadricSoA:
    """Spheres and the other quadrics, each with its object↔world
    transforms, so partial quadrics (z / φ clipping) stay exact.
    params: 0 radius, 1 z_min, 2 z_max, 3 phi_max, 4 and 5 extras (disk
    height and inner radius, cone height, hyperboloid a and c)."""
    kind: torch.Tensor          # (Q,) int64
    obj_to_world: torch.Tensor  # (Q, 4, 4)
    world_to_obj: torch.Tensor  # (Q, 4, 4)
    params: torch.Tensor        # (Q, 6)
    material_id: torch.Tensor   # (Q,) int64
    light_id: torch.Tensor      # (Q,) int64
    kinds_present: tuple = ()   # the kinds the intersection evaluates

    @property
    def count(self):
        return self.kind.shape[0]


def quadrics_from_numpy(arrs, device):
    """QuadricSoA from numpy columns kind, obj_to_world, world_to_obj,
    params, material_id, light_id (the JAX package's layout); None (or
    no rows) gives the empty pool."""
    if arrs is None:
        arrs = dict(kind=np.zeros(0), obj_to_world=np.zeros((0, 4, 4)),
                    world_to_obj=np.zeros((0, 4, 4)), params=np.zeros((0, 6)),
                    material_id=np.zeros(0), light_id=np.zeros(0))
    kind = np.asarray(arrs["kind"], np.int64)
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    return QuadricSoA(kind=t(kind, torch.int64), obj_to_world=t(arrs["obj_to_world"]),
                      world_to_obj=t(arrs["world_to_obj"]), params=t(arrs["params"]),
                      material_id=t(arrs["material_id"], torch.int64),
                      light_id=t(arrs["light_id"], torch.int64),
                      kinds_present=tuple(sorted(set(kind.tolist()))))


@dataclass
class Hit:
    """Wavefront hit record (SoA SurfaceInteraction)."""
    valid: torch.Tensor        # (N,) bool
    t: torch.Tensor            # (N,)
    p: torch.Tensor            # (N, 3)
    ng: torch.Tensor           # (N, 3) geometric normal, unit
    ns: torch.Tensor           # (N, 3) shading normal, unit
    uv: torch.Tensor           # (N, 2)
    dpdu: torch.Tensor         # (N, 3) unit tangent ⊥ ns
    wo: torch.Tensor           # (N, 3) -ray.d
    material_id: torch.Tensor  # (N,) int64
    light_id: torch.Tensor     # (N,) int64
    prim_kind: torch.Tensor    # (N,) int64: 0 triangle, 1 quadric
    prim_id: torch.Tensor      # (N,) int64
    uv_scale: torch.Tensor     # (N,) uv units per world unit at the hit
