"""The port's front end against pbrt_tpu: api.SceneBuilder, the `.pbrt`
loader, PLY meshes and image files.

- One scene through every SceneBuilder method (instances aside: they
  are held in tests/test_torch_instances.py) equals, through the bridge,
  the JAX builder's scene: every array bit for bit. With spatial_light_distrib the port's builder gives
  the scene lights.distrib.build_spatial's grid (which
  tests/test_torch_lights.py holds to the JAX package's; the JAX builder's
  own grid takes 8–27 s op by op, so its scene is built without one).
- load_pbrt of tests/test_pbrt_loader.py's scene plus a PLY mesh under a
  Rotate and a ConcatTransform, a spot light, named and unknown materials
  and the directives the loader skips: the scene arrays and the options
  equal the JAX loader's; the port's scene has its cluster set (the JAX
  loader's traces brute force).
- PLY files both ways between the packages, binary and ASCII.
- EXR, PFM and NPY bytes equal the JAX writers'; PNG pixels within one
  level of 255 (the gamma curve's pow may differ by an ulp).
- The loaded scene at 16×16, 2 spp, direct lighting through a thin lens
  with the mitchell filter against pbrt_tpu: tests/test_oracle.py's pixel
  check.

Torch runs on one thread."""
import dataclasses

import numpy as np
import pytest
import torch

from pbrt_tpu.api import SceneBuilder
from pbrt_tpu.cameras import make_perspective as jmake_perspective
from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.film import filters as jfilt, io as jio
from pbrt_tpu.geom import meshio as jmesh
from pbrt_tpu.integrate import direct as jdirect, driver as jdriver
from pbrt_tpu.pbrt_loader import load_pbrt as jload_pbrt
from pbrt_tpu.shade import bssrdf as jbss
from pbrt_tpu.shade import fourier as jfou
from tests.test_oracle import _check
from tests.test_pbrt_loader import SCENE
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sensor import camera_dict
from tests.test_torch_shade import scene_tree
from tests.test_torch_sss import assert_same_scene
from tests.test_torch_textures import port_sss_table

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.api import SceneBuilder as TSceneBuilder
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.film import filters as tfilt, io as tio
from pbrt_tpu_torch.geom import meshio as tmesh
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver
from pbrt_tpu_torch.lights import distrib as tdistrib
from pbrt_tpu_torch.pbrt_loader import load_pbrt
from pbrt_tpu_torch.shade import fourier as tfou
from pbrt_tpu_torch.shade import materials as tmat


def every_method(b, fourier_table, spatial=False):
    """A scene through every builder method but instancing; `b` is either
    package's SceneBuilder and `fourier_table` its Lambertian table."""
    tx = b.textures
    check = tx.checkerboard((0.8, 0.8, 0.8), (0.2, 0.2, 0.2), su=4.0, sv=4.0)
    mats = [b.matte(kd=(0.6, 0.5, 0.4), sigma=10.0), b.plastic((0.4, 0.2, 0.1), (0.3,) * 3),
            b.glass(eta=1.4, roughness=0.05), b.metal(roughness=0.1), b.mirror(kr=0.8),
            b.substrate((0.5, 0.4, 0.3), (0.04,) * 3, roughness=0.2),
            b.uber(kd=0.3, ks=0.2, kr=0.1, opacity=0.9), b.translucent(kd=0.4),
            b.fourier(table=fourier_table), b.subsurface(eta=1.3),
            b.material(kind=tmat.MAT_MATTE, kd=(1.0, 1.0, 1.0), kd_tex=check)]
    b.medium_interface(mats[2], inside=0, outside=-1)
    r = np.random.RandomState(5)
    v = r.rand(30, 3).astype(np.float32)
    b.add_mesh(v, r.randint(0, 30, (40, 3)), mats[0], normals=v - 0.5,
               uvs=r.rand(30, 2).astype(np.float32))
    b.add_quad([0, 0, 0], [2, 0, 0], [2, 0, -2], [0, 0, -2], mats[10])
    b.add_quad([0, 2, 0], [0, 2, -2], [2, 2, -2], [2, 2, 0], mats[1],
               uvs=np.array([[0, 0], [2, 0], [2, 2], [0, 2]], np.float32))
    o2w = np.eye(4, dtype=np.float32)
    o2w[:3, 3] = (1.0, 0.5, -1.0)
    b.add_sphere([0.5, 0.5, -0.5], 0.2, mats[3], z_min=-0.1, phi_max=5.0)
    b.add_disk(o2w, 0.3, mats[4], height=0.1, inner_radius=0.1)
    b.add_cylinder(o2w, 0.2, -0.1, 0.2, mats[5])
    b.add_cone(o2w, 0.2, 0.3, mats[6], phi_max=4.0)
    b.add_paraboloid(o2w, 0.2, 0.0, 0.3, mats[7])
    b.add_hyperboloid(o2w, 4.0, 2.0, -0.2, 0.3, mats[8])
    b.add_sphere([1.5, 0.3, -1.5], 0.15, mats[9])
    b.point_light([1.0, 1.8, -1.0], (1.0, 0.9, 0.8))
    b.spot_light([0.2, 1.9, -0.2], [0.3, -1.0, -0.3], (2.0, 2.0, 2.0), cone_deg=35.0)
    b.distant_light([0.2, 1.0, 0.3], (0.5, 0.5, 0.5))
    b.area_light_quad([0.8, 1.99, -0.8], [0.8, 1.99, -1.2], [1.2, 1.99, -1.2],
                      [1.2, 1.99, -0.8], (8.0, 8.0, 8.0), two_sided=True)
    b.area_light_mesh(v[:3] + 1.0, [[0, 1, 2]], (3.0, 3.0, 3.0), material=mats[0])
    b.area_light_sphere([1.7, 1.5, -0.3], 0.1, (5.0, 4.0, 3.0))
    b.infinite_light(radiance=0.5, image=r.rand(8, 16, 3).astype(np.float32))
    b.set_homogeneous_medium((0.1,) * 3, (0.2,) * 3, g=0.3)
    b.set_grid_medium(r.rand(4, 4, 4).astype(np.float32), (0.1,) * 3, (0.5,) * 3, g=0.1,
                      world_to_medium=np.diag([0.5, 0.5, -0.5, 1.0]), scale=2.0)
    b.use_bvh = True
    b.spatial_light_distrib = spatial
    return b


def test_every_builder_method_equals_the_jax_builder(monkeypatch):
    monkeypatch.setattr(jbss, "compute_beam_diffusion_table", port_sss_table)
    js = every_method(SceneBuilder(), jfou.make_lambertian_table((0.6, 0.4, 0.3))).build()
    native = every_method(TSceneBuilder(), tfou.make_lambertian_table((0.6, 0.4, 0.3)),
                          spatial=True).build(device="cpu")
    via_bridge = bridge.scene_from_numpy(scene_tree(js), "cpu")
    assert_same_scene(native, via_bridge, ("tri", "quad", "materials", "textures", "lights",
                                           "media"))
    assert native.quad.kinds_present == (0, 1, 2, 3, 4, 5)
    assert native.lights.kinds_present == (0, 1, 2, 3, 4, 5)
    assert native.media.kinds_present == js.media.kinds_present
    for f in ("packed", "bounds"):
        assert torch.equal(getattr(native.clusters, f), getattr(via_bridge.clusters, f))
    assert js.light_distrib is None and via_bridge.light_distrib is None
    want = tdistrib.build_spatial(dataclasses.replace(native, light_distrib=None),
                                  native.lights)
    for f in ("grid_cdf", "grid_func", "world_min", "world_ext"):
        assert torch.equal(getattr(native.light_distrib, f), getattr(want, f)), f
    assert native.light_distrib.resolution == (8, 8, 8)
    # the instancing methods (they raised before the port had instances):
    # the JAX builder's ids and instance set (tests/test_torch_instances.py
    # holds the rest)
    jb, tb = SceneBuilder(), TSceneBuilder()
    for b in (jb, tb):
        assert b.instanced_prototype(np.eye(3), [[0, 1, 2]]) == 0
        assert b.add_instance(0, b.matte(kd=0.5), np.eye(4)) == 0
    ji, ti = jb.build().instances, tb.build(device="cpu").instances
    assert len(ti) == len(ji) == 1 and ti[0].count == 1
    for f in ("q0", "t0", "lin", "bmin", "bmax"):
        assert np.array_equal(getattr(ti[0], f).numpy(), np.asarray(getattr(ji[0], f))), f


PLY_SCENE = SCENE.replace("WorldEnd", """  AttributeBegin
    Translate 0.3 0.1 -0.4
    Rotate 30 0 1 0
    ConcatTransform [0.2 0 0 0  0 0.2 0 0  0 0 0.2 0  0.01 0.02 0 1]
    MakeNamedMaterial "gold" "string type" "metal" "float roughness" [0.05]
    NamedMaterial "gold"
    Shape "plymesh" "string filename" "blob.ply"
  AttributeEnd
  AttributeBegin
    NamedMaterial "nothing by this name"
    Texture "grid" "color" "checkerboard" "float uscale" [8]
    Include "missing.pbrt"
    Transform [1 0 0 0  0 1 0 0  0 0 1 0  0.7 0.3 -0.3 1]
    Shape "sphere" "float radius" [0.05]
    Shape "disk" "float radius" [0.1]
  AttributeEnd
  LightSource "spot" "point from" [0.2 0.9 -0.2] "point to" [0.3 0 -0.5] "rgb I" [2 2 2]
  LightSource "distant" "point from" [0 1 0] "point to" [0 0 0] "rgb L" [0.1 0.1 0.1]
WorldEnd""")


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    v, f, vn = tmesh.bench_blob(1)
    tmesh.write_ply(d / "blob.ply", v, f, normals=vn)
    (d / "scene.pbrt").write_text(PLY_SCENE)
    return str(d / "scene.pbrt")


def test_load_pbrt_equals_the_jax_loader(scene_file):
    js, jc, jopts = jload_pbrt(scene_file)
    ts, tc, topts = load_pbrt(scene_file, device="cpu")
    assert topts == jopts == {"integrator": "path", "max_depth": 4, "sampler": "zerotwo",
                              "spp": 4}
    assert tc.resolution == jc.resolution == (24, 24)
    np.testing.assert_allclose(tc.camera_to_world.m.numpy(), np.asarray(jc.camera_to_world.m),
                               atol=1e-6)
    assert_same_scene(ts, bridge.scene_from_numpy(scene_tree(js), "cpu"),
                      ("tri", "quad", "materials", "lights"))
    assert js.clusters is None and ts.clusters is not None       # bvh=True in the port
    assert ts.tri.count == 6 + 80 and ts.quad.count == 3 and ts.lights.count == 4
    # the blob went through Rotate and ConcatTransform in float64
    v, _, _ = tmesh.bench_blob(1)
    m = np.eye(4)
    m[:3, 3] = (0.3, 0.1, -0.4)
    m = m @ np.asarray(jtf_rotate(30.0, [0, 1, 0]), np.float64) @ np.array(
        [[0.2, 0, 0, 0.01], [0, 0.2, 0, 0.02], [0, 0, 0.2, 0], [0, 0, 0, 1]])
    want = (v.astype(np.float64) @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
    assert np.array_equal(ts.tri.positions[12:12 + len(v)].numpy(), want)


def jtf_rotate(angle, axis):
    from pbrt_tpu.core import transform as jtf
    return np.asarray(jtf.rotate(angle, np.asarray(axis, np.float64)).m)


def test_rotation_matrices_equal_the_jax_package():
    from pbrt_tpu.core import transform as jtf
    from pbrt_tpu_torch.core import transform as ttf
    for ang in (30.0, 45.0, 90.0, -120.0, 37.5):
        for axis in ([0, 1, 0], [1, 2, 3], [-0.3, 0.2, 0.9]):
            assert np.array_equal(ttf.rotate_np(ang, axis), jtf_rotate(ang, axis))
        for t, j in ((ttf.rotate_x_np, jtf.rotate_x), (ttf.rotate_y_np, jtf.rotate_y),
                     (ttf.rotate_z_np, jtf.rotate_z)):
            assert np.array_equal(t(ang), np.asarray(j(ang).m))
    np.testing.assert_allclose(ttf.orthographic_np(0.0, 1.0),
                               np.asarray(jtf.orthographic(0.0, 1.0).m))
    m = ttf.rotate_np(37.5, [1, 2, 3]) @ np.diag([2.0, 0.5, 1.0, 1.0]).astype(np.float32)
    m[:3, 3] = (0.1, -0.2, 0.3)
    tm, jm = ttf.from_matrix(m, "cpu"), jtf.from_matrix(m)
    assert np.array_equal(tm.m.numpy(), np.asarray(jm.m))
    np.testing.assert_allclose(tm.m_inv.numpy(), np.asarray(jm.m_inv), rtol=0, atol=1e-6)


ASCII_PLY = """ply
format ascii 1.0
element vertex 5
property float x
property float y
property float z
property float nx
property float ny
property float nz
property float u
property float v
element face 2
property list uchar int vertex_indices
end_header
0 0 0 0 0 1 0 0
1 0 0 0 0 1 1 0
1 1 0 0 0 1 1 1
0 1 0 0 0 1 0 1
0.5 0.5 1 0 0 1 0.5 0.5
4 0 1 2 3
3 0 1 4
"""


def test_ply_both_ways(tmp_path):
    r = np.random.RandomState(2)
    v, f, n = (r.rand(50, 3).astype(np.float32), r.randint(0, 50, (70, 3)),
               r.rand(50, 3).astype(np.float32))
    for writer, reader, tag in ((tmesh.write_ply, jmesh.read_ply, "port"),
                                (jmesh.write_ply, tmesh.read_ply, "jax")):
        for normals in (None, n):
            p = tmp_path / f"{tag}_{normals is None}.ply"
            writer(p, v, f, normals=normals)
            mesh = reader(str(p))
            assert np.array_equal(mesh["vertices"], v) and np.array_equal(mesh["indices"], f)
            assert ("normals" in mesh) == (normals is not None)
            if normals is not None:
                assert np.array_equal(mesh["normals"], n)
    jmesh.write_ply(tmp_path / "j.ply", v, f, normals=n)
    tmesh.write_ply(tmp_path / "t.ply", v, f, normals=n)
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    (tmp_path / "a.ply").write_text(ASCII_PLY)
    mj, mt = jmesh.read_ply(str(tmp_path / "a.ply")), tmesh.read_ply(str(tmp_path / "a.ply"))
    assert mt.keys() == mj.keys() == {"vertices", "indices", "normals", "uvs"}
    for k in mt:
        assert mt[k].dtype == mj[k].dtype and np.array_equal(mt[k], mj[k]), k
    assert mt["indices"].tolist() == [[0, 1, 2], [0, 2, 3], [0, 1, 4]]
    heights = r.rand(5, 7)
    hv, hi = tmesh.heightfield_mesh(heights, scale=0.5)
    jv, ji = jmesh.heightfield_mesh(heights, scale=0.5)
    assert hv.shape == (35, 3) and hi.shape == (48, 3)
    assert hv.dtype == jv.dtype and np.array_equal(hv, jv)
    assert hi.dtype == ji.dtype and np.array_equal(hi, ji)


def test_image_files_equal_the_jax_writers(tmp_path):
    r = np.random.RandomState(4)
    img = (r.rand(7, 9, 3) * 1.5).astype(np.float32)
    img[0, 0] = [0.0, 1e-5, 7e3]
    for ext in ("exr", "pfm", "npy"):
        jio.write_image(str(tmp_path / f"j.{ext}"), img)
        tio.write_image(str(tmp_path / f"t.{ext}"), torch.as_tensor(img))
        assert (tmp_path / f"j.{ext}").read_bytes() == (tmp_path / f"t.{ext}").read_bytes(), ext
        for reader in (tio.read_image, jio.read_image):
            back = reader(str(tmp_path / f"t.{ext}"))
            assert back.dtype == np.float32 and np.array_equal(back, img), ext
    jio.write_png(str(tmp_path / "j.png"), img)
    tio.write_png(str(tmp_path / "t.png"), torch.as_tensor(img))
    dj, dt = jio.read_png(str(tmp_path / "j.png")), tio.read_png(str(tmp_path / "t.png"))
    levels = lambda x: np.asarray(jio.spectrum.gamma_correct(x)) * 255.0  # noqa: E731
    assert np.abs(levels(dt) - levels(dj)).max() < 1.0 + 1e-3
    np.testing.assert_allclose(tio.read_png(str(tmp_path / "j.png")), dj, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tio.write_image(str(tmp_path / "x.tiff"), img)


def test_loaded_scene_renders_as_the_jax_package(scene_file, monkeypatch):
    """16×16, 2 spp, direct lighting through a thin lens (the JAX camera
    carried across) with the mitchell filter. A pixel whose two samples
    drew weights of opposite sign has a weight sum of 0, which both
    packages divide by 1e-10 (film.resolve; some 1e9 in value): those
    pixels are held at rtol 1e-4, the others to the pixel check."""
    res, spp = 16, 2
    js, jc, opts = jload_pbrt(scene_file)
    ts, _, _ = load_pbrt(scene_file, device="cpu")
    jlens = jmake_perspective(jc.camera_to_world, 40.0, (res, res), lens_radius=0.03,
                              focal_distance=1.6)
    tlens = bridge.camera_from_numpy(camera_dict(jlens), "cpu")
    kw = dict(width=res, height=res, spp=spp, max_depth=opts["max_depth"])
    jf = jfilt.Filter("mitchell", radius=2.0)
    jcfg = jdriver.RenderConfig(**kw, filter=jf,
                                sampler=jsmp.SamplerConfig(kind=opts["sampler"], spp=spp))
    tcfg = tdriver.RenderConfig(**kw, filter=tfilt.Filter("mitchell", radius=2.0),
                                sampler=tsmp.SamplerConfig(kind=opts["sampler"], spp=spp))
    # the JAX package builds the |f| table with numpy, which a jit trace
    # cannot: built once here, outside the trace
    table = jfilt._abs_cdf_table(jf)
    monkeypatch.setattr(jfilt, "_abs_cdf_table", lambda f, n=256: table)
    with reference_jit():
        img_j = np.asarray(jdriver.render(js, jlens, jcfg, jdirect.make_li(jcfg)))
    img_t = tdriver.render(ts, tlens, tcfg, tdirect.make_li(tcfg)).numpy()
    pid, sid = tdriver.lane_ids(tcfg, 0, spp, "cpu")
    fw = tdriver.camera_rays(tlens, tcfg, pid, sid)[3]
    cancelled = (fw.sum(0) == 0).reshape(res, res).numpy()
    assert np.isfinite(img_t).all() and 0 < cancelled.sum() < 0.2 * res * res
    np.testing.assert_allclose(img_t[cancelled], img_j[cancelled], rtol=1e-4)
    _check(img_t[~cancelled], img_j[~cancelled])
    assert img_t[~cancelled].mean() > 0.01
