"""SceneBuilder — the user-facing scene construction API (counterpart of
pbrt_tpu/api.py, the same methods and argument names). It gathers meshes,
quadrics, materials, textures, media and lights on the host in numpy and
`build` makes the port's Scene on a device (cuda unless told otherwise),
with the cluster set of its triangles, and of each instanced prototype,
when `bvh` (or `use_bvh`) is set. As in the JAX package, `build` makes no
BVHArrays: geom/bvh.py builds them for a caller that asks."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .geom import cluster as clmod
from .geom import instances as instmod
from .geom.scene import Scene, world_bounds
from .geom.types import (QUAD_CONE, QUAD_CYLINDER, QUAD_DISK, QUAD_HYPERBOLOID,
                         QUAD_PARABOLOID, QUAD_SPHERE, quadrics_from_numpy,
                         triangles_from_numpy)
from .lights import lights as lightsmod
from .shade import materials as matmod
from .shade import media as medmod


class SceneBuilder:
    def __init__(self):
        self._verts, self._normals, self._uvs, self._tris = [], [], [], []
        self._tri_mat, self._tri_light, self._tri_has_ns = [], [], []
        self._vert_base = self._tri_base = 0
        self._quads = []      # (kind, obj_to_world, params, material, light)
        self._materials, self._lights = [], []
        self._env_image = self._env_to_world = None
        self._media_rows, self._media_grid = None, None
        self._textures = None
        self._protos = []          # instanced prototypes: (v, idx, normals, uvs, has_ns)
        self._instances = []       # (proto, material, T0, T1 or None, light id)
        self.use_bvh = False
        self.spatial_light_distrib = False

    @property
    def textures(self):
        """The TextureBuilder, made on first use; pass its texture ids to the
        material rows' *_tex keys (e.g. kd_tex=b.textures.checkerboard(...))."""
        from .shade.textures import TextureBuilder
        if self._textures is None:
            self._textures = TextureBuilder()
        return self._textures

    # ---- materials -----------------------------------------------------
    def material(self, **kw):
        """Add a material row (see shade.materials.build_materials)."""
        self._materials.append(kw)
        return len(self._materials) - 1

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

    def fourier(self, bsdf_file=None, table=None):
        """Measured Fourier BSDF: a PBRT-v3 .bsdf file or a prebuilt
        shade.fourier.FourierTable."""
        if table is None:
            from .shade.fourier import load_bsdf_file
            table = load_bsdf_file(bsdf_file)
        return self.material(kind=matmod.MAT_FOURIER, fourier_table=table)

    def subsurface(self, sigma_a=(0.0011, 0.0024, 0.014), sigma_s=(2.55, 3.21, 3.77),
                   g=0.0, eta=1.33, scale=1.0, roughness=0.0, remap=True):
        """Tabulated-BSSRDF material (defaults about skim milk); kr = kt = 1,
        the interface lobes weight by Fresnel themselves."""
        aux = list(np.broadcast_to(np.asarray(sigma_a, np.float32), (3,))) \
            + list(np.broadcast_to(np.asarray(sigma_s, np.float32), (3,))) + [g, scale]
        return self.material(kind=matmod.MAT_SUBSURFACE, eta=eta, aux=aux, kr=1.0, kt=1.0,
                             roughness=(roughness, roughness), remap_roughness=remap)

    # ---- geometry ------------------------------------------------------
    def add_mesh(self, vertices, indices, material, normals=None, uvs=None, light=-1):
        """vertices (V, 3), indices (T, 3). Returns the scene triangle ids
        [t0, t1) of the mesh."""
        v = np.asarray(vertices, np.float32)
        f = np.asarray(indices, np.int32).reshape(-1, 3)
        t0 = self._tri_base
        self._verts.append(v)
        self._normals.append(np.zeros_like(v) if normals is None
                             else np.asarray(normals, np.float32))
        self._uvs.append(np.zeros((len(v), 2), np.float32) if uvs is None
                         else np.asarray(uvs, np.float32))
        self._tris.append(f + self._vert_base)
        self._tri_mat.append(np.full(len(f), material, np.int32))
        self._tri_light.append(np.full(len(f), light, np.int32))
        self._tri_has_ns.append(np.full(len(f), normals is not None, bool))
        self._vert_base += len(v)
        self._tri_base += len(f)
        return t0, self._tri_base

    def add_quad(self, p0, p1, p2, p3, material, light=-1, uvs=None):
        """Planar quad p0..p3 (counter-clockwise) as two triangles."""
        uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32) if uvs is None else uvs
        return self.add_mesh(np.array([p0, p1, p2, p3], np.float32), [[0, 1, 2], [0, 2, 3]],
                             material, uvs=uv, light=light)

    def _add_quadric(self, kind, o2w, params, material, light=-1):
        self._quads.append((kind, np.asarray(o2w, np.float32),
                            np.asarray(params, np.float32), material, light))
        return len(self._quads) - 1

    def add_sphere(self, center, radius, material, light=-1, z_min=None, z_max=None,
                   phi_max=2 * np.pi):
        o2w = np.eye(4, dtype=np.float32)
        o2w[:3, 3] = center
        r = float(radius)
        return self._add_quadric(QUAD_SPHERE, o2w,
                                 [r, -r if z_min is None else z_min,
                                  r if z_max is None else z_max, phi_max, 0.0, 0.0],
                                 material, light)

    def add_disk(self, o2w, radius, material, height=0.0, inner_radius=0.0,
                 phi_max=2 * np.pi, light=-1):
        return self._add_quadric(QUAD_DISK, o2w, [radius, 0, 0, phi_max, height, inner_radius],
                                 material, light)

    def add_cylinder(self, o2w, radius, z_min, z_max, material, phi_max=2 * np.pi, light=-1):
        return self._add_quadric(QUAD_CYLINDER, o2w, [radius, z_min, z_max, phi_max, 0, 0],
                                 material, light)

    def add_cone(self, o2w, radius, height, material, phi_max=2 * np.pi, light=-1):
        return self._add_quadric(QUAD_CONE, o2w, [radius, 0, height, phi_max, height, 0],
                                 material, light)

    def add_paraboloid(self, o2w, radius, z_min, z_max, material, phi_max=2 * np.pi,
                       light=-1):
        return self._add_quadric(QUAD_PARABOLOID, o2w, [radius, z_min, z_max, phi_max, 0, 0],
                                 material, light)

    def add_hyperboloid(self, o2w, a, c, z_min, z_max, material, phi_max=2 * np.pi,
                        light=-1):
        return self._add_quadric(QUAD_HYPERBOLOID, o2w,
                                 [max(abs(z_min), abs(z_max)), z_min, z_max, phi_max, a, c],
                                 material, light)

    # ---- instancing ------------------------------------------------------
    def instanced_prototype(self, vertices, indices, normals=None, uvs=None):
        """A mesh stored once and shared by instances (TransformedPrimitive,
        primitive.rs:105-177). Returns the prototype id."""
        v = np.asarray(vertices, np.float32).reshape(-1, 3)
        idx = np.asarray(indices, np.int32).reshape(-1, 3)
        n = np.zeros_like(v) if normals is None else np.asarray(normals, np.float32).reshape(-1, 3)
        uv = np.zeros((len(v), 2), np.float32) if uvs is None \
            else np.asarray(uvs, np.float32).reshape(-1, 2)
        self._protos.append((v, idx, n, uv, np.full(len(idx), normals is not None)))
        return len(self._protos) - 1

    def add_instance(self, proto, material, transform, transform1=None, emit=None):
        """Prototype `proto` under the 4x4 object-to-world `transform` at
        shutter open; `transform1` (optional) at shutter close: rigid motion
        blur by per-ray quaternion slerp (transform.rs:2010). `emit` (RGB
        radiance) makes the instance an area light: its world-space
        triangles go into the light table as corner rows (the reference's
        TransformedPrimitive has no area light, primitive.rs:161-163; the
        JAX package's builder adds this). An emissive instance cannot move."""
        light_id = -1
        if emit is not None:
            if transform1 is not None and not np.allclose(np.asarray(transform1),
                                                          np.asarray(transform)):
                raise ValueError("emissive instances cannot be animated")
            v, idx = self._protos[int(proto)][:2]
            m = np.asarray(transform, np.float64)
            pw = v @ m[:3, :3].T + m[:3, 3]
            light_id = self._light(kind=lightsmod.LIGHT_AREA_TRI, L=emit,
                                   tris=np.concatenate([pw[idx[:, c]] for c in range(3)], 1))
        self._instances.append((int(proto), int(material), np.asarray(transform, np.float64),
                                None if transform1 is None
                                else np.asarray(transform1, np.float64), light_id))
        return len(self._instances) - 1

    # ---- media ---------------------------------------------------------
    def medium_interface(self, material, inside=-1, outside=0):
        """The media a ray enters when it transmits into / out of surfaces
        of `material` (-1 = vacuum)."""
        self._materials[material]["med_inside"] = int(inside)
        self._materials[material]["med_outside"] = int(outside)
        return material

    def set_homogeneous_medium(self, sigma_a, sigma_s, g=0.0):
        """A homogeneous medium filling the scene (medium 0)."""
        self._media_rows = [dict(kind=medmod.MEDIUM_HOMOGENEOUS, sigma_a=sigma_a,
                                 sigma_s=sigma_s, g=g)]
        self._media_grid = None
        return 0

    def set_grid_medium(self, density, sigma_a, sigma_s, g=0.0, world_to_medium=None,
                        scale=1.0):
        """A density-grid medium filling the scene (medium 0)."""
        row = dict(kind=medmod.MEDIUM_GRID, sigma_a=sigma_a, sigma_s=sigma_s, g=g,
                   scale=scale)
        if world_to_medium is not None:
            row["world_to_medium"] = world_to_medium
        self._media_rows, self._media_grid = [row], density
        return 0

    # ---- lights --------------------------------------------------------
    def _light(self, **row):
        self._lights.append(row)
        return len(self._lights) - 1

    def point_light(self, p, intensity):
        return self._light(kind=lightsmod.LIGHT_POINT, p=p, I=intensity)

    def spot_light(self, p, direction, intensity, cone_deg=30.0, falloff_deg=25.0):
        return self._light(kind=lightsmod.LIGHT_SPOT, p=p, direction=direction, I=intensity,
                           cone_deg=cone_deg, falloff_deg=falloff_deg)

    def distant_light(self, direction_to_light, radiance):
        return self._light(kind=lightsmod.LIGHT_DISTANT, direction=direction_to_light,
                           L=radiance)

    def area_light_quad(self, p0, p1, p2, p3, radiance, two_sided=False, material=None):
        """Emissive quad; a black matte material unless one is given."""
        if material is None:
            material = self.matte(kd=0.0)
        t0, t1 = self.add_quad(p0, p1, p2, p3, material, light=len(self._lights))
        return self._light(kind=lightsmod.LIGHT_AREA_TRI, tri_ids=list(range(t0, t1)),
                           L=radiance, two_sided=two_sided)

    def area_light_mesh(self, vertices, indices, radiance, two_sided=False, material=None):
        if material is None:
            material = self.matte(kd=0.0)
        t0, t1 = self.add_mesh(vertices, indices, material, light=len(self._lights))
        return self._light(kind=lightsmod.LIGHT_AREA_TRI, tri_ids=list(range(t0, t1)),
                           L=radiance, two_sided=two_sided)

    def area_light_sphere(self, center, radius, radiance, material=None):
        if material is None:
            material = self.matte(kd=0.0)
        qid = self.add_sphere(center, radius, material, light=len(self._lights))
        return self._light(kind=lightsmod.LIGHT_AREA_SPHERE, quadric_id=qid, L=radiance)

    def infinite_light(self, radiance=1.0, image=None, env_to_world=None):
        self._env_image, self._env_to_world = image, env_to_world
        return self._light(kind=lightsmod.LIGHT_INFINITE, L=radiance)

    # ---- build ---------------------------------------------------------
    def build(self, bvh=None, device=None, tile=clmod.TILE):
        """The Scene on `device`. With `bvh` (default: use_bvh) its triangles
        are traced through the cluster set (the CUDA kernels on the card),
        else by the brute-force tracers."""
        device = resolve_device(device)
        if not self._materials:
            self.matte(kd=(0.0, 0.0, 0.0))   # shape-less scenes still gather row 0

        def cat(parts, shape, dt):
            return np.concatenate(parts) if parts else np.zeros(shape, dt)

        pos = cat(self._verts, (0, 3), np.float32)
        idx = cat(self._tris, (0, 3), np.int32)
        tri = triangles_from_numpy(pos, idx, cat(self._normals, (0, 3), np.float32),
                                   cat(self._uvs, (0, 2), np.float32),
                                   cat(self._tri_has_ns, (0,), bool),
                                   cat(self._tri_mat, (0,), np.int32),
                                   cat(self._tri_light, (0,), np.int32), device)
        qa = None
        if self._quads:
            o2w = np.stack([q[1] for q in self._quads])
            qa = dict(kind=np.array([q[0] for q in self._quads], np.int64), obj_to_world=o2w,
                      world_to_obj=np.linalg.inv(o2w),
                      params=np.stack([q[2] for q in self._quads]),
                      material_id=np.array([q[3] for q in self._quads], np.int64),
                      light_id=np.array([q[4] for q in self._quads], np.int64))
        use_bvh = self.use_bvh if bvh is None else bvh
        isets = self._instance_sets(device, use_bvh)
        center, radius = world_bounds(pos, *((qa["params"], qa["obj_to_world"], qa["kind"])
                                             if qa else (None,) * 3), instances=isets)
        scene = Scene(
            tri=tri, quad=quadrics_from_numpy(qa, device),
            clusters=clmod.build_clusters(pos, idx, device) if use_bvh and len(idx) else None,
            materials=matmod.build_materials(self._materials, device),
            lights=lightsmod.build_lights(self._lights, pos, idx,
                                          None if qa is None else qa["params"],
                                          self._env_image, self._env_to_world, device=device),
            textures=None if self._textures is None else self._textures.build(device),
            light_distrib=None,
            world_center=torch.as_tensor(center, device=device),
            world_radius=radius, tile=tile,
            media=(None if self._media_rows is None
                   else medmod.build_media(self._media_rows, self._media_grid, device)),
            instances=isets)
        if self.spatial_light_distrib:
            from .lights import distrib
            scene = dataclasses.replace(scene, light_distrib=distrib.build_spatial(
                scene, scene.lights))
        return scene

    def _instance_sets(self, device, clusters):
        """One InstanceSet per prototype that has instances, or None."""
        sets = []
        for pid, (v, idx, n, uv, has_ns) in enumerate(self._protos):
            rows = [r for r in self._instances if r[0] == pid]
            if not rows:
                continue
            t = len(idx)
            proto = triangles_from_numpy(v, idx, n, uv, has_ns, np.zeros(t, np.int32),
                                         np.full(t, -1, np.int32), device)
            sets.append(instmod.build_instances(
                proto, [r[2] for r in rows], [r[1] for r in rows],
                transforms1=[r[2] if r[3] is None else r[3] for r in rows],
                light_ids=[r[4] for r in rows], clusters=clusters))
        return tuple(sets) or None
