"""Scenes built natively, without the JAX package: the bench scene (the
textured bunny stand-in, an 81,920-triangle displaced icosphere at
subdivisions=6, in an open box with a wood-textured matte floor, a
plastic blob and one quad area light; counterpart of
scenes/bunny.mesh_scene with use_bvh=True) and the Cornell box with two
spheres of the baseline configs (counterpart of
scenes/cornell.cornell_spheres), through the parts of
pbrt_tpu.api.SceneBuilder.build and geom.cluster.build_clusters they use;
the Cornell box with a table of all eight light kinds, and config 2's
published size; baseline config 4, the fog-filled box and its smoke
variant (counterpart of scenes/volumetric.py), and the bench scene in
fog."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .cameras import cameras as cammod
from .core import transform as tf
from .geom import cluster as clmod
from .geom.meshio import bench_blob
from .geom.scene import Scene, world_bounds
from .geom.types import (QUAD_CONE, QUAD_CYLINDER, QUAD_DISK, QUAD_HYPERBOLOID,
                         QUAD_PARABOLOID, QUAD_SPHERE, quadrics_from_numpy,
                         triangles_from_numpy)
from .lights import lights as lightsmod
from .shade import materials as matmod
from .shade import media as medmod
from .shade import textures as texmod
from .shade.fourier import make_lambertian_table

# Baseline config 2 (BASELINE.json) at its published size: the Cornell box
# with a mirror and a glass sphere, path at depth 5, 256×256 at 64 spp,
# traced in wavefronts of CORNELL_SPP_BATCH samples (1,048,576 lanes)
CORNELL_RES, CORNELL_SPP, CORNELL_SPP_BATCH = 256, 64, 16


def wood_image(size=512):
    """Procedural plank image baked to a texture."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    rings = 0.5 + 0.5 * np.sin((x * 9.0 + 0.35 * np.sin(y * 23.0)) * np.pi * 2.0)
    planks = (np.floor(y * 8.0) % 2.0)
    base = np.stack([0.45 + 0.25 * rings, 0.28 + 0.16 * rings,
                     0.14 + 0.08 * rings], axis=-1)
    return (base * (0.8 + 0.2 * planks[..., None])).astype(np.float32)


class _Builder:
    """The parts of SceneBuilder the native scenes use: meshes and quads,
    the six quadrics, material rows of every kind and medium interfaces,
    a texture table of every kind, area quad, point and infinite lights,
    and one homogeneous or grid medium, built into the port's Scene."""

    def __init__(self):
        self.verts, self.normals, self.uvs, self.tris = [], [], [], []
        self.mat, self.light, self.has_ns = [], [], []
        self.quads = []       # (kind, obj_to_world, params, material, light)
        self.materials, self.lights = [], []
        self.textures = texmod.TextureBuilder()
        self.env_image = self.env_to_world = None
        self.media_rows, self.media_grid = None, None
        self.vbase = 0
        self.tbase = 0

    def material(self, **kw):
        self.materials.append(kw)
        return len(self.materials) - 1

    def matte(self, kd, sigma=0.0):
        return self.material(kind=matmod.MAT_MATTE, kd=kd, sigma=sigma)

    def plastic(self, kd, ks, roughness=0.1, remap=True):
        return self.material(kind=matmod.MAT_PLASTIC, kd=kd, ks=ks,
                             roughness=(roughness, roughness), remap_roughness=remap)

    def glass(self, kr=1.0, kt=1.0, eta=1.5, roughness=0.0, remap=True):
        return self.material(kind=matmod.MAT_GLASS, kr=kr, kt=kt, eta=eta,
                             roughness=(roughness, roughness), remap_roughness=remap)

    def metal(self, eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14), roughness=0.01, ks=1.0,
              remap=True):
        return self.material(kind=matmod.MAT_METAL, metal_eta=eta, metal_k=k, ks=ks,
                             roughness=(roughness, roughness), remap_roughness=remap)

    def mirror(self, kr=0.9):
        return self.material(kind=matmod.MAT_MIRROR, kr=kr)

    def substrate(self, kd, ks, roughness=0.1, remap=True):
        return self.material(kind=matmod.MAT_SUBSTRATE, kd=kd, ks=ks,
                             roughness=(roughness, roughness), remap_roughness=remap)

    def uber(self, kd=0.25, ks=0.25, kr=0.0, opacity=1.0, roughness=0.1, eta=1.5):
        return self.material(kind=matmod.MAT_UBER, kd=kd, ks=ks, kr=kr, opacity=opacity,
                             roughness=(roughness, roughness), eta=eta)

    def translucent(self, kd=0.25, reflect=0.5, transmit=0.5):
        return self.material(kind=matmod.MAT_TRANSLUCENT, kd=kd, kr=reflect, kt=transmit)

    def fourier(self, table):
        """A Fourier BSDF row on `table` (shade.fourier.FourierTable)."""
        return self.material(kind=matmod.MAT_FOURIER, fourier_table=table)

    def subsurface(self, sigma_a=(0.0011, 0.0024, 0.014), sigma_s=(2.55, 3.21, 3.77),
                   g=0.0, eta=1.33, scale=1.0, roughness=0.0, remap=True):
        """Tabulated-BSSRDF row (defaults about skim milk); kr = kt = 1, the
        interface lobes weight by Fresnel themselves."""
        aux = list(np.broadcast_to(np.asarray(sigma_a, np.float32), (3,))) \
            + list(np.broadcast_to(np.asarray(sigma_s, np.float32), (3,))) + [g, scale]
        return self.material(kind=matmod.MAT_SUBSURFACE, eta=eta, aux=aux, kr=1.0, kt=1.0,
                             roughness=(roughness, roughness), remap_roughness=remap)

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

    def _quadric(self, kind, o2w, params, material, light=-1):
        self.quads.append((kind, np.asarray(o2w, np.float32),
                           np.asarray(params, np.float32), material, light))
        return len(self.quads) - 1

    def add_sphere(self, center, radius, material, light=-1, z_min=None, z_max=None,
                   phi_max=2 * np.pi):
        o2w = np.eye(4, dtype=np.float32)
        o2w[:3, 3] = center
        r = float(radius)
        return self._quadric(QUAD_SPHERE, o2w, [r, -r if z_min is None else z_min,
                                                r if z_max is None else z_max, phi_max, 0, 0],
                             material, light)

    def add_disk(self, o2w, radius, material, height=0.0, inner_radius=0.0,
                 phi_max=2 * np.pi, light=-1):
        return self._quadric(QUAD_DISK, o2w, [radius, 0, 0, phi_max, height, inner_radius],
                             material, light)

    def add_cylinder(self, o2w, radius, z_min, z_max, material, phi_max=2 * np.pi, light=-1):
        return self._quadric(QUAD_CYLINDER, o2w, [radius, z_min, z_max, phi_max, 0, 0],
                             material, light)

    def add_cone(self, o2w, radius, height, material, phi_max=2 * np.pi, light=-1):
        return self._quadric(QUAD_CONE, o2w, [radius, 0, height, phi_max, height, 0],
                             material, light)

    def add_paraboloid(self, o2w, radius, z_min, z_max, material, phi_max=2 * np.pi,
                       light=-1):
        return self._quadric(QUAD_PARABOLOID, o2w, [radius, z_min, z_max, phi_max, 0, 0],
                             material, light)

    def add_hyperboloid(self, o2w, a, c, z_min, z_max, material, phi_max=2 * np.pi,
                        light=-1):
        return self._quadric(QUAD_HYPERBOLOID, o2w,
                             [max(abs(z_min), abs(z_max)), z_min, z_max, phi_max, a, c],
                             material, light)

    def area_light_quad(self, p0, p1, p2, p3, radiance, two_sided=False):
        material = self.matte(kd=0.0)
        light_id = len(self.lights)
        t0, t1 = self.add_quad(p0, p1, p2, p3, material, light=light_id)
        self.lights.append(dict(kind=lightsmod.LIGHT_AREA_TRI, tri_ids=list(range(t0, t1)),
                                L=radiance, two_sided=two_sided))
        return light_id

    def point_light(self, p, intensity):
        self.lights.append(dict(kind=lightsmod.LIGHT_POINT, p=p, I=intensity))
        return len(self.lights) - 1

    def infinite_light(self, radiance=1.0, image=None, env_to_world=None):
        self.lights.append(dict(kind=lightsmod.LIGHT_INFINITE, L=radiance))
        self.env_image, self.env_to_world = image, env_to_world
        return len(self.lights) - 1

    def medium_interface(self, material, inside=-1, outside=0):
        """The media a ray enters when it transmits into / out of surfaces
        of `material` (-1 = vacuum)."""
        self.materials[material]["med_inside"] = int(inside)
        self.materials[material]["med_outside"] = int(outside)
        return material

    def set_homogeneous_medium(self, sigma_a, sigma_s, g=0.0):
        """A homogeneous medium filling the scene (medium 0)."""
        self.media_rows = [dict(kind=medmod.MEDIUM_HOMOGENEOUS, sigma_a=sigma_a,
                                sigma_s=sigma_s, g=g)]
        self.media_grid = None
        return 0

    def set_grid_medium(self, density, sigma_a, sigma_s, g=0.0, world_to_medium=None,
                        scale=1.0):
        """A density-grid medium filling the scene (medium 0)."""
        row = dict(kind=medmod.MEDIUM_GRID, sigma_a=sigma_a, sigma_s=sigma_s, g=g,
                   scale=scale)
        if world_to_medium is not None:
            row["world_to_medium"] = world_to_medium
        self.media_rows, self.media_grid = [row], density
        return 0

    def build(self, device, tile, clusters=True):
        if not self.materials:
            self.matte(kd=(0.0, 0.0, 0.0))   # shape-less scenes still gather row 0
        cat = lambda parts, shape, dt: (np.concatenate(parts) if parts  # noqa: E731
                                        else np.zeros(shape, dt))
        pos = cat(self.verts, (0, 3), np.float32)
        idx = cat(self.tris, (0, 3), np.int32)
        tri = triangles_from_numpy(pos, idx, cat(self.normals, (0, 3), np.float32),
                                   cat(self.uvs, (0, 2), np.float32),
                                   cat(self.has_ns, (0,), bool), cat(self.mat, (0,), np.int32),
                                   cat(self.light, (0,), np.int32), device)
        qa = None
        if self.quads:
            o2w = np.stack([q[1] for q in self.quads])
            qa = dict(kind=np.array([q[0] for q in self.quads], np.int64), obj_to_world=o2w,
                      world_to_obj=np.linalg.inv(o2w),
                      params=np.stack([q[2] for q in self.quads]),
                      material_id=np.array([q[3] for q in self.quads], np.int64),
                      light_id=np.array([q[4] for q in self.quads], np.int64))
        center, radius = world_bounds(pos, *((qa["params"], qa["obj_to_world"], qa["kind"])
                                             if qa else ()))
        return Scene(
            tri=tri, quad=quadrics_from_numpy(qa, device),
            clusters=clmod.build_clusters(pos, idx, device) if clusters and len(idx) else None,
            materials=matmod.build_materials(self.materials, device),
            lights=lightsmod.build_lights(self.lights, pos, idx,
                                          None if qa is None else qa["params"],
                                          self.env_image, self.env_to_world, device=device),
            textures=self.textures.build(device) if self.textures.rows else None,
            light_distrib=None,
            world_center=torch.as_tensor(center, device=device),
            world_radius=radius, tile=tile,
            media=(None if self.media_rows is None
                   else medmod.build_media(self.media_rows, self.media_grid, device)))


BLOBS = ("plastic", "metal", "subsurface")


def bench_scene(subdivisions=6, device=None, tile=clmod.TILE, blob="plastic"):
    """The bench scene on `device` (cuda unless told otherwise). `blob` is
    the blob's material: "plastic" (the bench), "metal" (counterpart of
    mesh_scene(metal_blob=True)) or "subsurface" (SceneBuilder.subsurface
    at its defaults)."""
    if blob not in BLOBS:
        raise ValueError(f"blob {blob!r}: expected one of {BLOBS}")
    device = resolve_device(device)
    b = _Builder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    wood = b.textures.image(wood_image(), su=3.0, sv=3.0)
    floor_mat = b.material(kind=matmod.MAT_MATTE, kd=(1.0, 1.0, 1.0), kd_tex=wood,
                           sigma=0.0)
    blob_mat = {"plastic": lambda: b.plastic(kd=(0.4, 0.25, 0.12), ks=(0.3, 0.3, 0.3),
                                             roughness=0.08),
                "metal": lambda: b.metal(roughness=0.05),
                "subsurface": b.subsurface}[blob]()
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


# fog_scene's default medium: sigma_a, sigma_s, g
FOG = ((0.08, 0.08, 0.08), (0.45, 0.45, 0.45), 0.2)


def bench_fog_scene(subdivisions=6, device=None, tile=clmod.TILE):
    """The bench scene filled with fog_scene's default medium. The bench
    box is the same unit box as config 4's, so the density means the same."""
    scene = bench_scene(subdivisions, device, tile)
    return dataclasses.replace(scene, media=medmod.build_media(
        [dict(kind=medmod.MEDIUM_HOMOGENEOUS, sigma_a=FOG[0], sigma_s=FOG[1], g=FOG[2])],
        device=scene.device))


def fog_scene(sigma_a=FOG[0], sigma_s=FOG[1], g=FOG[2], device=None, tile=clmod.TILE):
    """Baseline config 4 (counterpart of scenes/volumetric.fog_scene): a
    Cornell-style box with a mirror sphere, filled with a homogeneous
    scattering medium."""
    b = _Builder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    red = b.matte(kd=(0.65, 0.05, 0.05))
    green = b.matte(kd=(0.12, 0.45, 0.15))
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], white)
    b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)
    b.add_quad([0, 0, 0], [0, 0, -s], [0, s, -s], [0, s, 0], red)
    b.add_quad([s, 0, 0], [s, s, 0], [s, s, -s], [s, 0, -s], green)
    b.add_sphere([0.4, 0.25, -0.55], 0.22, b.mirror(kr=0.85))
    e, c, y = 0.2, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                      [c + e, y, -c - e], [c + e, y, -c + e], radiance=(22.0, 22.0, 22.0))
    b.set_homogeneous_medium(sigma_a, sigma_s, g)
    return b.build(resolve_device(device), tile)


def smoke_scene(device=None, tile=clmod.TILE):
    """Config 4's grid-density variant (counterpart of
    scenes/volumetric.smoke_scene): a smoke column over a floor and a back
    wall; medium space is the unit cube on the box interior."""
    b = _Builder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)
    e, c, y = 0.2, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                      [c + e, y, -c - e], [c + e, y, -c + e], radiance=(18.0, 18.0, 18.0))
    # density: a gaussian column modulated by hashed noise
    n = 32
    z, yy, x = np.mgrid[0:n, 0:n, 0:n] / (n - 1.0)
    base = np.exp(-((x - 0.5) ** 2 + (z - 0.5) ** 2) / 0.05) * (1.0 - yy) ** 0.5
    zoom = np.kron(np.random.RandomState(4).rand(8, 8, 8), np.ones((4, 4, 4)))
    dens = np.clip(base * (0.5 + zoom), 0.0, 1.0).astype(np.float32)
    w2m = np.eye(4, dtype=np.float32)
    w2m[2, 2] = -1.0     # world z in [-1, 0] -> medium z in [0, 1]
    b.set_grid_medium(dens, sigma_a=(0.05,) * 3, sigma_s=(0.9,) * 3, g=0.0,
                      world_to_medium=w2m, scale=8.0)
    return b.build(resolve_device(device), tile)


def cornell_sky(n_theta=32, n_phi=64):
    """The Cornell env variant's sky: a bright warm band near the zenith."""
    th = np.linspace(0, np.pi, n_theta)[:, None] * np.ones((1, n_phi))
    band = np.exp(-((th - 0.5) ** 2) / 0.18)
    return np.stack([1.6 * band + 0.25, 1.3 * band + 0.3, 1.0 * band + 0.45],
                    axis=-1).astype(np.float32)


def cornell_spheres(specular=False, light="area", device=None, clusters=True,
                    tile=clmod.TILE):
    """The Cornell box in [0,1]^3 with two spheres (the baseline configs
    1 and 2; counterpart of scenes/cornell.cornell_spheres). specular:
    a mirror and a glass sphere in place of the matte ones. light:
    "area" (a ceiling quad), "point", or "env" (no ceiling; the sky of
    cornell_sky). With `clusters` the triangles run through the cluster
    tracer (one cluster), else through the brute-force tracers."""
    b = _Builder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    red = b.matte(kd=(0.65, 0.05, 0.05))
    green = b.matte(kd=(0.12, 0.45, 0.15))
    if specular:
        sph1, sph2 = b.mirror(kr=0.9), b.glass(eta=1.5)
    else:
        sph1, sph2 = b.matte(kd=(0.8, 0.6, 0.2)), b.matte(kd=(0.2, 0.4, 0.8))
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], white)       # floor
    if light != "env":
        b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)   # ceiling
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)     # back
    b.add_quad([0, 0, 0], [0, 0, -s], [0, s, -s], [0, s, 0], red)         # left
    b.add_quad([s, 0, 0], [s, s, 0], [s, s, -s], [s, 0, -s], green)       # right
    b.add_sphere([0.3, 0.18, -0.6], 0.18, sph1)
    b.add_sphere([0.7, 0.15, -0.35], 0.15, sph2)
    if light == "area":
        e, c, y = 0.22, s / 2, s - 1e-3
        b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                          [c + e, y, -c - e], [c + e, y, -c + e], radiance=(12.0, 12.0, 12.0))
    elif light == "env":
        b.infinite_light(radiance=1.0, image=cornell_sky())
    elif light == "point":
        b.point_light([0.5, 0.85, -0.5], intensity=(1.2, 1.2, 1.2))
    else:
        raise ValueError(f"light {light!r}: expected 'area', 'point' or 'env'")
    return b.build(resolve_device(device), tile, clusters)


def appearance_rows(b, fourier_table, marble=True):
    """Fill builder `b` with the appearance box: config 2's Cornell box
    (walls, mirror and glass spheres, ceiling light) with seven small
    spheres along the back wall, so that it has a surface of each material
    kind but mix, each texture kind on some channel and a bump-mapped back
    wall. `b` is this module's _Builder or the JAX package's SceneBuilder:
    both take these calls; `fourier_table` is that package's Lambertian
    table. Without `marble` the plastic sphere's kd is a constant in place
    of the marble texture (the JAX package cannot evaluate marble on more
    than one lane)."""
    tx = b.textures
    const = tx.constant((0.73, 0.73, 0.73))
    checker = tx.checkerboard((0.8, 0.8, 0.8), (0.3, 0.3, 0.3), su=6.0, sv=6.0)
    sigma = tx.scale(tx.uv(), 40.0)
    mix = tx.mix(tx.dots((0.9, 0.85, 0.2), (0.65, 0.05, 0.05), su=8.0, sv=8.0),
                 tx.bilerp((0.7, 0.1, 0.1), (0.4, 0.05, 0.2), (0.9, 0.3, 0.1), (0.5, 0.1, 0.0)),
                 0.5)
    wood = tx.image(wood_image(64), su=2.0, sv=2.0)
    bump = tx.fbm(octaves=4, omega=0.5)
    wrinkled = tx.wrinkled(octaves=3, omega=0.6)
    checker3d = tx.checkerboard((0.95, 0.64, 0.54), (0.6, 0.6, 0.6), dims=3)
    windy = tx.windy()
    kr_const = tx.constant((0.9, 0.9, 0.9))
    white = b.material(kind=matmod.MAT_MATTE, kd=(0.73, 0.73, 0.73), kd_tex=const,
                       sigma_tex=sigma)
    back = b.material(kind=matmod.MAT_MATTE, kd=(0.73, 0.73, 0.73), kd_tex=wood,
                      bump_tex=bump)
    left = b.material(kind=matmod.MAT_MATTE, kd=(0.65, 0.05, 0.05), kd_tex=mix)
    floor = b.material(kind=matmod.MAT_SUBSTRATE, kd=(0.5, 0.5, 0.5), ks=(0.04, 0.04, 0.04),
                       roughness=(0.1, 0.1), kd_tex=checker)
    right = b.material(kind=matmod.MAT_TRANSLUCENT, kd=(0.12, 0.45, 0.15), kr=0.5, kt=0.5,
                       kt_tex=wrinkled)
    mirror = b.material(kind=matmod.MAT_MIRROR, kr=(0.9, 0.9, 0.9), kr_tex=kr_const)
    glass = b.glass(eta=1.5)
    metal = b.material(kind=matmod.MAT_METAL, metal_eta=(0.2, 0.92, 1.1),
                       metal_k=(3.9, 2.45, 2.14), ks=1.0, roughness=(0.05, 0.05),
                       ks_tex=checker3d)
    plastic = b.material(kind=matmod.MAT_PLASTIC, kd=(0.4, 0.25, 0.12), ks=(0.3, 0.3, 0.3),
                         roughness=(0.08, 0.08),
                         **({"kd_tex": tx.marble(octaves=4, scale=6.0, variation=0.4)}
                            if marble else {}))
    uber = b.material(kind=matmod.MAT_UBER, kd=(0.3, 0.2, 0.5), ks=(0.3, 0.3, 0.3),
                      kr=(0.1, 0.1, 0.1), opacity=(0.9, 0.9, 0.9), roughness=(0.2, 0.2),
                      eta=1.5, roughness_tex=windy)
    disney = b.material(kind=matmod.MAT_DISNEY, kd=(0.8, 0.3, 0.2),
                        aux=(0.3, 0.2, 0.5, 0.5, 0.4, 0.8, 0.4, 0.0))
    sss = b.subsurface(sigma_a=(0.2, 0.5, 1.5), sigma_s=(30.0, 30.0, 30.0), g=0.0, eta=1.33)
    hair = b.material(kind=matmod.MAT_HAIR, kd=(0.3, 0.2, 0.1), ks=(0.4, 0.4, 0.4),
                      roughness=(0.3, 0.3))
    fourier = b.fourier(table=fourier_table)
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], floor)
    b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], back)
    b.add_quad([0, 0, 0], [0, 0, -s], [0, s, -s], [0, s, 0], left)
    b.add_quad([s, 0, 0], [s, s, 0], [s, s, -s], [s, 0, -s], right)
    b.add_sphere([0.3, 0.18, -0.6], 0.18, mirror)
    b.add_sphere([0.7, 0.15, -0.35], 0.15, glass)
    for i, m in enumerate((metal, plastic, uber, disney, sss, hair, fourier)):
        b.add_sphere([0.1 + 0.1333 * i, 0.065, -0.86], 0.065, m)
    e, c, y = 0.22, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                      [c + e, y, -c - e], [c + e, y, -c + e], radiance=(12.0, 12.0, 12.0))
    return b


def appearance_box(device=None, tile=clmod.TILE, marble=True):
    """The appearance box (appearance_rows) on `device`; its Fourier
    sphere carries the Lambertian table of albedo (0.6, 0.4, 0.3)."""
    device = resolve_device(device)
    b = appearance_rows(_Builder(), make_lambertian_table((0.6, 0.4, 0.3), device=device),
                        marble)
    return b.build(device, tile)


def all_kinds_rows(tri_ids):
    """Light rows of all eight kinds in the Cornell box: its ceiling quad
    (triangles tri_ids) and its first sphere as area lights beside a
    point, a spot, a distant, an infinite, a goniometric and a projection
    light (build_lights' rows; the JAX package's kind numbers are the
    same)."""
    return [dict(kind=lightsmod.LIGHT_POINT, p=(0.5, 0.85, -0.5), I=(1.2, 1.0, 0.8)),
            dict(kind=lightsmod.LIGHT_SPOT, p=(0.2, 0.9, -0.2), direction=(0.3, -1.0, -0.4),
                 I=(3.0, 3.0, 3.0), cone_deg=35.0, falloff_deg=20.0),
            dict(kind=lightsmod.LIGHT_DISTANT, direction=(0.2, 1.0, 0.3), L=(0.8, 0.9, 1.0)),
            dict(kind=lightsmod.LIGHT_AREA_TRI, tri_ids=list(tri_ids), L=(12.0, 12.0, 12.0)),
            dict(kind=lightsmod.LIGHT_AREA_SPHERE, quadric_id=0, L=(2.0, 1.5, 1.0)),
            dict(kind=lightsmod.LIGHT_INFINITE, L=1.0),
            dict(kind=lightsmod.LIGHT_GONIO, p=(0.8, 0.7, -0.7), I=(0.9, 0.9, 0.9)),
            dict(kind=lightsmod.LIGHT_PROJECTION, p=(0.5, 0.95, -0.4),
                 direction=(0.0, -1.0, -0.2), I=(2.0, 2.0, 2.0), fov_deg=50.0)]


def gonio_image():
    """The goniometric and projection lights' image: an 8×16 gradient."""
    y, x = np.mgrid[0:8, 0:16].astype(np.float32)
    return np.stack([x / 15.0, y / 7.0, 0.5 + 0.0 * x], -1) + 0.1


def with_all_light_kinds(scene):
    """A Cornell scene with the table of all_kinds_rows in place of its
    own (the infinite light on cornell_sky, gonio_image for the image
    lights)."""
    pos, idx = scene.tri.positions.cpu().numpy(), scene.tri.indices.cpu().numpy()
    rows = all_kinds_rows(np.nonzero(scene.tri.light_id.cpu().numpy() >= 0)[0])
    table = lightsmod.build_lights(rows, pos, idx, scene.quad.params.cpu().numpy(),
                                   cornell_sky(), gonio_image=gonio_image(),
                                   device=scene.device)
    return dataclasses.replace(scene, lights=table)


def cornell_camera(resolution, device=None):
    """The Cornell box's perspective camera at resolution (h, w)."""
    c2w = tf.look_at_np(pos=[0.5, 0.5, 1.42], look=[0.5, 0.5, -0.5], up=[0.0, 1.0, 0.0])
    return cammod.make_perspective(c2w, 40.0, resolution, resolve_device(device))


volumetric_camera = cornell_camera


def bench_camera(resolution, device=None):
    """The bench's perspective camera at resolution (h, w)."""
    c2w = tf.look_at_np(pos=[0.5, 0.5, 1.35], look=[0.5, 0.35, -0.5], up=[0.0, 1.0, 0.0])
    return cammod.make_perspective(c2w, 42.0, resolution, resolve_device(device))
