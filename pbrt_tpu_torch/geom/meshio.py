"""Mesh I/O and procedural meshes (counterpart of pbrt_tpu/geom/meshio.py):
PLY read (ASCII and binary little-endian) and write (binary), a
heightfield-to-mesh converter, and the ~81k-triangle displaced icosphere
that stands in for the Stanford bunny. All on the host, in numpy."""
from __future__ import annotations

import numpy as np

_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "int": "i4", "int32": "i4",
              "uint": "u4", "uint32": "u4", "uchar": "u1", "uint8": "u1", "char": "i1",
              "short": "i2", "ushort": "u2"}


def _fan(poly):
    """Fan triangles of one polygon's vertex ids."""
    return [[poly[0], poly[k], poly[k + 1]] for k in range(1, len(poly) - 1)]


def read_ply(path):
    """PLY reader: vertex x/y/z (and nx/ny/nz; u/v in ASCII files) and
    polygon faces, fan-triangulated. Returns dict(vertices, indices and,
    where the file has them, normals and uvs), float32 and int32."""
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.find(b"end_header\n") + len(b"end_header\n")
    fmt, elems = None, []          # elems: [name, count, [property...]]
    for line in data[:header_end].decode("ascii", "replace").splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elems.append([tok[1], int(tok[2]), []])
        elif tok[0] == "property":
            elems[-1][2].append(("list", tok[2], tok[3], tok[4]) if tok[1] == "list"
                                else (tok[1], tok[2]))
    out = {}
    body = data[header_end:]
    if fmt == "ascii":
        rows = body.decode("ascii").split()
        pos = 0
        for name, count, props in elems:
            if name == "vertex":
                ncols = len(props)
                vals = np.array(rows[pos:pos + count * ncols], np.float32).reshape(count, ncols)
                pos += count * ncols
                cols = [p[1] for p in props]
                out["vertices"] = vals[:, [cols.index(c) for c in "xyz"]]
                if all(c in cols for c in ("nx", "ny", "nz")):
                    out["normals"] = vals[:, [cols.index(c) for c in ("nx", "ny", "nz")]]
                if all(c in cols for c in ("u", "v")):
                    out["uvs"] = vals[:, [cols.index(c) for c in ("u", "v")]]
            elif name == "face":
                faces = []
                for _ in range(count):
                    n = int(rows[pos])
                    faces += _fan([int(rows[pos + 1 + k]) for k in range(n)])
                    pos += 1 + n
                out["indices"] = np.asarray(faces, np.int32)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elems:
            if name == "vertex":
                dt = np.dtype([(p[1], "<" + _PLY_TYPES[p[0]]) for p in props])
                arr = np.frombuffer(body, dt, count, off)
                off += dt.itemsize * count
                out["vertices"] = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
                if all(c in dt.names for c in ("nx", "ny", "nz")):
                    out["normals"] = np.stack([arr["nx"], arr["ny"], arr["nz"]],
                                              -1).astype(np.float32)
            elif name == "face":
                cnt_t = np.dtype("<" + _PLY_TYPES[props[0][1]])
                idx_t = np.dtype("<" + _PLY_TYPES[props[0][2]])
                faces = []
                for _ in range(count):
                    n = int(np.frombuffer(body, cnt_t, 1, off)[0])
                    off += cnt_t.itemsize
                    faces += _fan(np.frombuffer(body, idx_t, n, off))
                    off += idx_t.itemsize * n
                out["indices"] = np.asarray(faces, np.int32)
    else:
        raise ValueError(f"unsupported ply format {fmt}")
    return out


def write_ply(path, vertices, indices, normals=None):
    """Binary little-endian PLY: float x/y/z (and nx/ny/nz), uchar-counted
    int vertex_indices."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(indices, np.int32).reshape(-1, 3)
    hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {len(v)}",
           "property float x", "property float y", "property float z"]
    if normals is not None:
        hdr += ["property float nx", "property float ny", "property float nz"]
        v = np.concatenate([v, np.asarray(normals, np.float32)], axis=1)
    hdr += [f"element face {len(f)}", "property list uchar int vertex_indices",
            "end_header", ""]
    faces = np.zeros(len(f), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    faces["n"], faces["i"] = 3, f
    with open(path, "wb") as fh:
        fh.write("\n".join(hdr).encode())
        fh.write(v.astype("<f4").tobytes())
        fh.write(faces.tobytes())


def heightfield_mesh(heights, scale=1.0):
    """(H, W) height grid → (vertices (H·W, 3), indices) over the unit
    square in x and z, y the height times `scale`."""
    heights = np.asarray(heights)
    h, w = heights.shape
    ys, xs = np.mgrid[0:h, 0:w]
    verts = np.stack([xs / (w - 1), heights * scale, ys / (h - 1)],
                     axis=-1).reshape(-1, 3).astype(np.float32)
    a = (np.arange(h - 1)[:, None] * w + np.arange(w - 1)[None, :]).reshape(-1)
    idx = np.stack([a, a + 1, a + w, a + 1, a + w + 1, a + w], -1).reshape(-1, 3)
    return verts, idx.astype(np.int32)


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
