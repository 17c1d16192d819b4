"""Procedural bench mesh (counterpart of icosphere and bench_blob in
pbrt_tpu/geom/meshio.py): the ~81k-triangle displaced icosphere that
stands in for the Stanford bunny."""
from __future__ import annotations

import numpy as np


def icosphere(subdivisions=3, radius=1.0):
    """Subdivided icosahedron (unit sphere)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts_list[a] + verts_list[b]
                m /= np.linalg.norm(m)
                verts_list.append(m)
                edge_mid[key] = len(verts_list) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return (verts * radius).astype(np.float32), faces.astype(np.int32)


def bench_blob(subdivisions=6, radius=0.3, displace=0.12, seed=7):
    """Displaced icosphere with area-weighted vertex normals; 20·4^s
    triangles (81,920 at s=6)."""
    v, f = icosphere(subdivisions, 1.0)
    r = np.random.RandomState(seed)
    disp = np.zeros(len(v))
    for octv in range(4):
        freq = 2.0 ** octv * 3.0
        phase = r.rand(3) * 6.28
        amp = 0.5 ** octv
        disp += amp * np.sin(v @ (r.randn(3) * freq) + phase[0]) \
            * np.cos(v @ (r.randn(3) * freq) + phase[1])
    disp /= np.abs(disp).max()
    v_out = v * (1.0 + displace * disp[:, None]) * radius
    fn = np.cross(v_out[f[:, 1]] - v_out[f[:, 0]], v_out[f[:, 2]] - v_out[f[:, 0]])
    vn = np.zeros_like(v_out)
    np.add.at(vn, f[:, 0], fn)
    np.add.at(vn, f[:, 1], fn)
    np.add.at(vn, f[:, 2], fn)
    vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
    return v_out.astype(np.float32), f, vn.astype(np.float32)
