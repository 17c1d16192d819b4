"""A configuration's scene as plain tensors, built from its file: the
quads (two triangles each, uv (0,0) (1,0) (1,1) (0,1) on the corners),
the spheres, the materials by row and the area lights, each a quad that
emits on the side its corners wind toward and carries a black matte
row of its own, after the configuration's rows."""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MATTE, MIRROR, GLASS = 0, 1, 2
KINDS = {"matte": MATTE, "mirror": MIRROR, "glass": GLASS}
QUAD_UV = ((0.0, 0.0), (1.0, 0.0), (1.0, 1.0), (0.0, 1.0))
QUAD_TRIS = ((0, 1, 2), (0, 2, 3))


@dataclass
class Scene:
    tri: torch.Tensor          # (T, 3, 3) corners
    tri_uv: torch.Tensor       # (T, 3, 2)
    tri_mat: torch.Tensor      # (T,) material row
    tri_light: torch.Tensor    # (T,) light index or -1
    sph_c: torch.Tensor        # (S, 3)
    sph_r: list                # S radii (floats)
    sph_mat: list              # S material rows
    kind: torch.Tensor         # (M,)
    kd: torch.Tensor           # (M, 3)
    kr: torch.Tensor           # (M, 3)
    kt: torch.Tensor           # (M, 3)
    eta: torch.Tensor          # (M,)
    emit: torch.Tensor         # (L, 3)
    light_tris: list           # per light: its triangle rows
    light_cdf: list            # per light: float32 cdf over its triangles by area
    light_area: list           # per light: total area

    @property
    def n_lights(self):
        return len(self.light_tris)


def _vec3(v):
    return np.broadcast_to(np.asarray(v, np.float32), (3,))


def build(conf, device):
    """The scene of configuration data `conf` on `device`."""
    mats = list(conf["materials"]) + [{"kind": "matte", "kd": 0.0} for _ in conf["area_lights"]]
    kind = [KINDS[m["kind"]] for m in mats]
    kd = [_vec3(m.get("kd", 0.5)) for m in mats]
    kr = [_vec3(m.get("kr", 1.0 if m["kind"] == "glass" else 0.0)) for m in mats]
    kt = [_vec3(m.get("kt", 1.0 if m["kind"] == "glass" else 0.0)) for m in mats]
    eta = [float(m.get("eta", 1.5)) for m in mats]
    tris, uvs, tmat, tlight = [], [], [], []

    def quad(corners, mat, light):
        c = np.asarray(corners, np.float32)
        for t in QUAD_TRIS:
            tris.append(c[list(t)])
            uvs.append(np.asarray(QUAD_UV, np.float32)[list(t)])
            tmat.append(mat)
            tlight.append(light)
        return [len(tris) - 2, len(tris) - 1]

    for q in conf["quads"]:
        quad(q["corners"], q["material"], -1)
    light_tris, light_cdf, light_area, emit = [], [], [], []
    for i, lq in enumerate(conf["area_lights"]):
        ids = quad(lq["corners"], len(conf["materials"]) + i, i)
        c = np.asarray([tris[j] for j in ids], np.float64)
        areas = 0.5 * np.linalg.norm(np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]), axis=-1)
        light_tris.append(ids)
        light_cdf.append([float(np.float32(x)) for x in np.cumsum(areas) / areas.sum()])
        light_area.append(float(np.float32(areas.sum())))
        emit.append(_vec3(lq["radiance"]))
    f = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    sph = conf.get("spheres", [])
    return Scene(
        tri=torch.tensor(np.stack(tris), **f), tri_uv=torch.tensor(np.stack(uvs), **f),
        tri_mat=torch.tensor(tmat, **i64), tri_light=torch.tensor(tlight, **i64),
        sph_c=torch.tensor(np.asarray([s["center"] for s in sph], np.float32).reshape(-1, 3), **f),
        sph_r=[float(np.float32(s["radius"])) for s in sph], sph_mat=[s["material"] for s in sph],
        kind=torch.tensor(kind, **i64), kd=torch.tensor(np.stack(kd), **f),
        kr=torch.tensor(np.stack(kr), **f), kt=torch.tensor(np.stack(kt), **f),
        eta=torch.tensor(eta, **f), emit=torch.tensor(np.stack(emit), **f),
        light_tris=light_tris, light_cdf=light_cdf, light_area=light_area)


@dataclass
class Camera:
    pos: tuple
    rot: torch.Tensor      # (3, 3): camera axes (right, up, forward) as columns
    tan_half: float
    width: int
    height: int


def camera(conf, width, height, device):
    """A pinhole perspective camera: LookAt(pos, look, up), `fov_deg` across
    the image's shorter side."""
    c = conf["camera"]
    pos, look, up = (np.asarray(c[k], np.float64) for k in ("pos", "look", "up"))
    fwd = (look - pos) / np.linalg.norm(look - pos)
    right = np.cross(up / np.linalg.norm(up), fwd)
    right /= np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd], axis=1)
    return Camera(tuple(float(np.float32(x)) for x in pos),
                  torch.tensor(rot, dtype=torch.float32, device=device),
                  float(np.float32(math.tan(math.radians(c["fov_deg"]) / 2.0))), width, height)
