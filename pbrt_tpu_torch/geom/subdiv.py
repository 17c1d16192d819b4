"""Loop subdivision surfaces and curve tessellation, host-side mesh
preprocessing in numpy (the port's own copy of pbrt_tpu/geom/subdiv.py;
loopsubdiv.rs and curve.rs tessellated into triangles, which the tracers
then take as any mesh).
"""
from __future__ import annotations

import numpy as np


def loop_subdivide(vertices, faces, levels=2):
    """Loop subdivision (Loop 1987 weights, matching loopsubdiv.rs):
    returns (vertices, faces) after `levels` rounds + limit projection."""
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64).reshape(-1, 3)

    for _ in range(levels):
        nv = len(v)
        # edge → midpoint index, adjacency
        edge_map = {}
        edges = []          # (a, b) with a<b
        edge_faces = []     # up to 2 adjacent faces' opposite vertices
        for fi, (a, b, c) in enumerate(f):
            for (x, y, z) in ((a, b, c), (b, c, a), (c, a, b)):
                key = (min(x, y), max(x, y))
                if key not in edge_map:
                    edge_map[key] = len(edges)
                    edges.append(key)
                    edge_faces.append([z])
                else:
                    edge_faces[edge_map[key]].append(z)

        # new edge vertices
        ev = np.zeros((len(edges), 3))
        for ei, (a, b) in enumerate(edges):
            opp = edge_faces[ei]
            if len(opp) == 2:   # interior: 3/8 ends + 1/8 opposites
                ev[ei] = 0.375 * (v[a] + v[b]) + 0.125 * (v[opp[0]] + v[opp[1]])
            else:               # boundary: midpoint
                ev[ei] = 0.5 * (v[a] + v[b])

        # reposition old vertices
        neighbors = [[] for _ in range(nv)]
        boundary = [[] for _ in range(nv)]
        for ei, (a, b) in enumerate(edges):
            neighbors[a].append(b)
            neighbors[b].append(a)
            if len(edge_faces[ei]) == 1:
                boundary[a].append(b)
                boundary[b].append(a)
        v_new = np.zeros_like(v)
        for i in range(nv):
            ns = neighbors[i]
            k = len(ns)
            if boundary[i]:
                bs = boundary[i]
                v_new[i] = 0.75 * v[i] + 0.125 * (v[bs[0]] + v[bs[-1]])
            elif k:
                beta = (0.1875 if k == 3 else 3.0 / (8.0 * k))
                v_new[i] = (1 - k * beta) * v[i] + beta * np.sum(v[ns], axis=0)
            else:
                v_new[i] = v[i]

        # split each face into 4
        f_out = []
        for (a, b, c) in f:
            eab = edge_map[(min(a, b), max(a, b))] + nv
            ebc = edge_map[(min(b, c), max(b, c))] + nv
            eca = edge_map[(min(c, a), max(c, a))] + nv
            f_out += [[a, eab, eca], [b, ebc, eab], [c, eca, ebc], [eab, ebc, eca]]
        v = np.concatenate([v_new, ev])
        f = np.asarray(f_out, np.int64)

    return v.astype(np.float32), f.astype(np.int32)


def _bezier_point(cp, t):
    """Cubic Bézier eval, cp (4, 3), t (...,)."""
    t = np.asarray(t)[..., None]
    a = cp[0] * (1 - t) ** 3
    b = cp[1] * 3 * (1 - t) ** 2 * t
    c = cp[2] * 3 * (1 - t) * t ** 2
    d = cp[3] * t ** 3
    return a + b + c + d


def tessellate_curve(control_points, width0, width1, n_segments=16, n_radial=4,
                     curve_type="cylinder"):
    """Bézier curve → triangle tube/ribbon mesh (curve.rs geometry,
    tessellated). Returns (vertices, faces)."""
    cp = np.asarray(control_points, np.float64).reshape(4, 3)
    ts = np.linspace(0.0, 1.0, n_segments + 1)
    centers = _bezier_point(cp, ts)                       # (S+1, 3)
    # tangents
    d = np.gradient(centers, axis=0)
    d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-12)
    widths = (width0 * (1 - ts) + width1 * ts) * 0.5

    if curve_type == "flat" or curve_type == "ribbon":
        # camera/normal-oriented ribbon approximated with fixed frame
        up = np.array([0.0, 0.0, 1.0])
        side = np.cross(d, up)
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-12)
        left = centers - side * widths[:, None]
        right = centers + side * widths[:, None]
        verts = np.concatenate([left, right])
        faces = []
        s1 = n_segments + 1
        for i in range(n_segments):
            faces += [[i, i + 1, s1 + i], [i + 1, s1 + i + 1, s1 + i]]
        return verts.astype(np.float32), np.asarray(faces, np.int32)

    # cylinder tube
    verts = []
    for i, (c, t_, w) in enumerate(zip(centers, d, widths)):
        a = np.array([1.0, 0.0, 0.0]) if abs(t_[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
        n1 = np.cross(t_, a)
        n1 /= max(np.linalg.norm(n1), 1e-12)
        n2 = np.cross(t_, n1)
        for j in range(n_radial):
            phi = 2 * np.pi * j / n_radial
            verts.append(c + w * (np.cos(phi) * n1 + np.sin(phi) * n2))
    faces = []
    for i in range(n_segments):
        for j in range(n_radial):
            a = i * n_radial + j
            b = i * n_radial + (j + 1) % n_radial
            c = (i + 1) * n_radial + j
            dd = (i + 1) * n_radial + (j + 1) % n_radial
            faces += [[a, b, c], [b, dd, c]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)
