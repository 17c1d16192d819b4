"""The bench scene, built natively: the textured bunny stand-in (an
81,920-triangle displaced icosphere at subdivisions=6) in an open box with
a wood-textured matte floor, a plastic blob and one quad area light
(counterpart of scenes/bunny.mesh_scene with use_bvh=True, and of the
parts of pbrt_tpu.api.SceneBuilder.build and geom.cluster.build_clusters
this scene uses)."""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .cameras import cameras as cammod
from .core import transform as tf
from .geom import cluster as clmod
from .geom.meshio import bench_blob
from .geom.scene import Scene
from .geom.types import triangles_from_numpy
from .lights.lights import build_area_lights
from .shade import materials as matmod
from .shade.textures import build_image_textures


def wood_image(size=512):
    """Procedural plank image baked to a texture."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rings = 0.5 + 0.5 * np.sin((x * 9.0 + 0.35 * np.sin(y * 23.0)) * np.pi * 2.0)
    planks = (np.floor(y * 8.0) % 2.0)
    base = np.stack([0.45 + 0.25 * rings, 0.28 + 0.16 * rings,
                     0.14 + 0.08 * rings], axis=-1)
    return (base * (0.8 + 0.2 * planks[..., None])).astype(np.float32)


class _Builder:
    """The slice of SceneBuilder the bench scene uses: meshes, quads,
    material rows, one image texture list and triangle area lights."""

    def __init__(self):
        self.verts, self.normals, self.uvs, self.tris = [], [], [], []
        self.mat, self.light, self.has_ns = [], [], []
        self.materials, self.lights, self.images = [], [], []
        self.vbase = 0
        self.tbase = 0

    def material(self, **kw):
        self.materials.append(kw)
        return len(self.materials) - 1

    def image_texture(self, img, su, sv):
        self.images.append((img, su, sv))
        return len(self.images) - 1

    def add_mesh(self, v, f, material, normals=None, uvs=None, light=-1):
        v = np.asarray(v, np.float32)
        f = np.asarray(f, np.int32).reshape(-1, 3)
        t0 = self.tbase
        self.verts.append(v)
        self.normals.append(np.zeros_like(v) if normals is None
                            else np.asarray(normals, np.float32))
        self.uvs.append(np.zeros((len(v), 2), np.float32) if uvs is None
                        else np.asarray(uvs, np.float32))
        self.tris.append(f + self.vbase)
        self.mat.append(np.full(len(f), material, np.int32))
        self.light.append(np.full(len(f), light, np.int32))
        self.has_ns.append(np.full(len(f), normals is not None, bool))
        self.vbase += len(v)
        self.tbase += len(f)
        return t0, self.tbase

    def add_quad(self, p0, p1, p2, p3, material, light=-1):
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        return self.add_mesh(np.array([p0, p1, p2, p3], np.float32),
                             [[0, 1, 2], [0, 2, 3]], material, uvs=uv, light=light)

    def area_light_quad(self, p0, p1, p2, p3, radiance):
        material = self.material(kind=matmod.MAT_MATTE, kd=0.0, sigma=0.0)
        light_id = len(self.lights)
        t0, t1 = self.add_quad(p0, p1, p2, p3, material, light=light_id)
        self.lights.append(dict(tri_ids=list(range(t0, t1)), L=radiance))
        return light_id

    def build(self, device, tile):
        pos = np.concatenate(self.verts)
        idx = np.concatenate(self.tris)
        tri = triangles_from_numpy(pos, idx, np.concatenate(self.normals),
                                   np.concatenate(self.uvs), np.concatenate(self.has_ns),
                                   np.concatenate(self.mat), np.concatenate(self.light),
                                   device)
        lo, hi = pos.min(0), pos.max(0)
        center = (lo + hi) / 2.0
        return Scene(
            tri=tri,
            clusters=clmod.build_clusters(pos, idx, device),
            materials=matmod.build_materials(self.materials, device),
            lights=build_area_lights(self.lights, pos, idx, device),
            textures=build_image_textures(self.images, device),
            world_center=torch.as_tensor(center, dtype=torch.float32, device=device),
            world_radius=float(np.linalg.norm(hi - center)) + 1e-4,
            tile=tile)


def bench_scene(subdivisions=6, device=None, tile=clmod.TILE):
    """The bench scene on `device` (cuda unless told otherwise)."""
    device = resolve_device(device)
    b = _Builder()
    white = b.material(kind=matmod.MAT_MATTE, kd=(0.73, 0.73, 0.73), sigma=0.0)
    wood = b.image_texture(wood_image(), 3.0, 3.0)
    floor_mat = b.material(kind=matmod.MAT_MATTE, kd=(1.0, 1.0, 1.0), kd_tex=wood,
                           sigma=0.0)
    blob_mat = b.material(kind=matmod.MAT_PLASTIC, kd=(0.4, 0.25, 0.12),
                          ks=(0.3, 0.3, 0.3), roughness=(0.08, 0.08),
                          remap_roughness=True)
    v, f, vn = bench_blob(subdivisions)
    b.add_mesh(v + np.array([0.5, 0.35, -0.5], np.float32), f, blob_mat, normals=vn)
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], floor_mat)
    b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)
    e, c, y = 0.25, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                      [c + e, y, -c - e], [c + e, y, -c + e], radiance=(14.0, 14.0, 14.0))
    return b.build(device, tile)


def bench_camera(resolution, device=None):
    """The bench's perspective camera at resolution (h, w)."""
    c2w = tf.look_at_np(pos=[0.5, 0.5, 1.35], look=[0.5, 0.35, -0.5], up=[0.0, 1.0, 0.0])
    return cammod.make_perspective(c2w, 42.0, resolution, resolve_device(device))
