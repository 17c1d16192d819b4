"""Scenes built natively, without the JAX package: the bench scene (the
textured bunny stand-in, an 81,920-triangle displaced icosphere at
subdivisions=6, in an open box with a wood-textured matte floor, a
plastic blob and one quad area light; counterpart of
scenes/bunny.mesh_scene with use_bvh=True) and the Cornell box with two
spheres of the baseline configs (counterpart of
scenes/cornell.cornell_spheres); the Cornell box with a table of all
eight light kinds, and config 2's published size; baseline config 4, the
fog-filled box and its smoke variant (counterpart of
scenes/volumetric.py), the bench scene in fog, the appearance box, and the
instance field (the bench room with 64 instances of one mesh, some moving
over the shutter, and an emissive instance). Each is built with
api.SceneBuilder."""
from __future__ import annotations

import dataclasses

import numpy as np

from . import resolve_device
from .api import SceneBuilder
from .cameras import cameras as cammod
from .core import transform as tf
from .geom import cluster as clmod
from .geom.meshio import bench_blob, icosphere, read_ply
from .geom.subdiv import loop_subdivide
from .lights import lights as lightsmod
from .shade import materials as matmod
from .shade import media as medmod
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


BLOBS = ("plastic", "metal", "subsurface")


def bench_scene(subdivisions=6, device=None, tile=clmod.TILE, blob="plastic", ply=None):
    """The bench scene on `device` (cuda unless told otherwise). `blob` is
    the blob's material: "plastic" (the bench), "metal" (counterpart of
    mesh_scene(metal_blob=True)) or "subsurface" (SceneBuilder.subsurface
    at its defaults). `ply`: a PLY mesh in place of the blob, scaled to
    0.6 across its longest side and centred at (0.5, 0.3, -0.5) (as
    mesh_scene(ply=...))."""
    if blob not in BLOBS:
        raise ValueError(f"blob {blob!r}: expected one of {BLOBS}")
    device = resolve_device(device)
    b = SceneBuilder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    wood = b.textures.image(wood_image(), su=3.0, sv=3.0)
    floor_mat = b.material(kind=matmod.MAT_MATTE, kd=(1.0, 1.0, 1.0), kd_tex=wood,
                           sigma=0.0)
    blob_mat = {"plastic": lambda: b.plastic(kd=(0.4, 0.25, 0.12), ks=(0.3, 0.3, 0.3),
                                             roughness=0.08),
                "metal": lambda: b.metal(roughness=0.05),
                "subsurface": b.subsurface}[blob]()
    if ply is None:
        v, f, vn = bench_blob(subdivisions)
        v = v + np.array([0.5, 0.35, -0.5], np.float32)
    else:
        mesh = read_ply(ply)
        v, f, vn = mesh["vertices"], mesh["indices"], mesh.get("normals")
        lo, hi = v.min(0), v.max(0)
        v = (v - (lo + hi) / 2.0) / max(hi - lo) * 0.6 + np.array([0.5, 0.3, -0.5], np.float32)
    b.add_mesh(v, f, blob_mat, normals=vn)
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], floor_mat)
    b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)
    e, c, y = 0.25, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                      [c + e, y, -c - e], [c + e, y, -c + e], radiance=(14.0, 14.0, 14.0))
    return b.build(True, device, tile)


def _rotation(axis, angle):
    """4x4 rotation by `angle` radians about `axis` (Rodrigues, float64)."""
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    m = np.eye(4)
    m[:3, :3] = np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k
    return m


def instance_field(n_side=8, proto_subdivisions=3, animated=16, device=None,
                   tile=clmod.TILE):
    """The instance field on `device` (cuda unless told otherwise): the bench
    room (wood floor, ceiling, back wall, the 14-radiance quad light) without
    the blob, and an n_side × n_side grid over the floor of instances of one
    prototype, a Loop-subdivided icosphere (icosphere(1) through
    proto_subdivisions - 1 levels of subdiv.loop_subdivide: 1,280 triangles
    at 3; 64 × 1,280 = the bench blob's 81,920 at n_side 8), about 0.05
    across. Rotations and per-axis scales 0.8–1.2 come from
    np.random.RandomState(5); `animated` of the instances move over the
    shutter, 0.04 along x and 30° about y; the materials cycle through
    plastic, metal and matte. One static instance of a 2-triangle quad
    prototype on the back wall emits radiance 4. Built with `bvh`: the
    room's triangles and each prototype run through the cluster tracer."""
    device = resolve_device(device)
    b = SceneBuilder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    wood = b.textures.image(wood_image(), su=3.0, sv=3.0)
    floor_mat = b.material(kind=matmod.MAT_MATTE, kd=(1.0, 1.0, 1.0), kd_tex=wood,
                           sigma=0.0)
    mats = (b.plastic(kd=(0.4, 0.25, 0.12), ks=(0.3, 0.3, 0.3), roughness=0.08),
            b.metal(roughness=0.05), b.matte(kd=(0.6, 0.6, 0.6)))
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], floor_mat)
    b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)
    e, c, y = 0.25, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e],
                      [c + e, y, -c - e], [c + e, y, -c + e], radiance=(14.0, 14.0, 14.0))
    v, f = icosphere(1)
    v, f = loop_subdivide(v, f, levels=proto_subdivisions - 1)
    proto = b.instanced_prototype(v, f, normals=v / np.linalg.norm(v, axis=1, keepdims=True))
    r = np.random.RandomState(5)
    n = n_side * n_side
    axes, angles = r.randn(n, 3), r.uniform(0.0, 2.0 * np.pi, n)
    scales = r.uniform(0.8, 1.2, (n, 3))
    moving = set(r.choice(n, min(animated, n), replace=False).tolist())
    grid = (np.arange(n_side) + 0.5) / n_side * 0.8 + 0.1
    spin = _rotation((0.0, 1.0, 0.0), np.pi / 6.0)
    for i in range(n):
        lin = _rotation(axes[i], angles[i]) @ np.diag([*(0.025 * scales[i]), 1.0])
        m0 = tf.translate_np([grid[i % n_side], 0.04, -grid[i // n_side]]) @ lin
        m1 = None
        if i in moving:
            m1 = tf.translate_np([grid[i % n_side] + 0.04, 0.04, -grid[i // n_side]]) \
                @ spin @ lin
        b.add_instance(proto, mats[i % 3], m0, transform1=m1)
    panel = b.instanced_prototype([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.5, 0.0],
                                   [-0.5, 0.5, 0.0]], [[0, 1, 2], [0, 2, 3]])
    b.add_instance(panel, b.matte(kd=0.0),
                   tf.translate_np([0.25, 0.6, -0.99]) @ tf.scale_np([0.2, 0.2, 1.0]),
                   emit=(4.0, 4.0, 4.0))
    return b.build(True, device, tile)


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
    b = SceneBuilder()
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
    return b.build(True, resolve_device(device), tile)


def smoke_scene(device=None, tile=clmod.TILE):
    """Config 4's grid-density variant (counterpart of
    scenes/volumetric.smoke_scene): a smoke column over a floor and a back
    wall; medium space is the unit cube on the box interior."""
    b = SceneBuilder()
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
    return b.build(True, resolve_device(device), tile)


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
    b = SceneBuilder()
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
    return b.build(clusters, resolve_device(device), tile)


def appearance_rows(b, fourier_table, marble=True):
    """Fill builder `b` with the appearance box: config 2's Cornell box
    (walls, mirror and glass spheres, ceiling light) with seven small
    spheres along the back wall, so that it has a surface of each material
    kind but mix, each texture kind on some channel and a bump-mapped back
    wall. `b` is api.SceneBuilder or the JAX package's SceneBuilder: both
    take these calls; `fourier_table` is that package's Lambertian
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
    b = appearance_rows(SceneBuilder(), make_lambertian_table((0.6, 0.4, 0.3),
                                                              device=device), marble)
    return b.build(True, device, tile)


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
