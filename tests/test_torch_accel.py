"""The port's accelerators, subdivision and CPU oracle against pbrt_tpu.

- BVH: build_bvh's arrays (the native builder) equal the JAX build's
  exactly; traverse_closest / traverse_any against the JAX traversals on
  tests/test_geometry.py's triangle soups (hit and triangle ids equal, t
  at rtol 1e-5, barycentrics at atol 1e-3), and the brute-force tracers,
  also through geom/scene.py's BVH branch.
- kd-tree: build_kdtree's arrays equal the JAX build's; traverse_closest
  against the JAX traversal and the brute-force tracer.
- loop_subdivide and tessellate_curve (cylinder and ribbon) bit for bit.
- oracle.render_direct bit for bit equal to
  pbrt_tpu.oracle.cpu_reference.render_direct on the Cornell box at 16×16
  (point and area light), on the bridged scene and camera; and the port's
  direct render against it (tests/test_oracle.py's check).

Torch runs on one thread."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.geom import bvh as jbvh, kdtree as jkd, meshio as jmesh
from pbrt_tpu.geom import subdiv as jsub
from pbrt_tpu.oracle import cpu_reference as joracle
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_geometry import _random_soup, _tri_soa
from tests.test_oracle import _check
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sensor import camera_dict
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.geom import bvh as tbvh, kdtree as tkd, scene as tscene
from pbrt_tpu_torch.geom import subdiv as tsub, triangle as ttri
from pbrt_tpu_torch.geom.types import triangles_from_numpy
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver
from pbrt_tpu_torch.oracle import cpu_reference as toracle

RTOL, ATOL = 1e-5, 1e-6
# Möller–Trumbore's barycentrics cancel in float32: XLA and PyTorch give
# them up to 1.5e-4 apart on these soups (t agrees at rtol 1e-5); the
# port's BVH and brute force, one Möller–Trumbore, agree bit for bit
BARY_ATOL = 1e-3


def _tri(verts, idx):
    t = len(idx)
    return triangles_from_numpy(verts, idx, np.zeros_like(verts), np.zeros((len(verts), 2)),
                                np.zeros(t, bool), np.zeros(t), np.full(t, -1), "cpu")


def _rays(n, seed, tmax=np.inf, verts=None):
    """tests/test_geometry.py's rays; with `verts`, three in four aimed at
    a random triangle's centroid (a random soup is mostly empty space)."""
    r = np.random.RandomState(seed)
    o = (r.rand(n, 3) * 10).astype(np.float32)
    d = r.randn(n, 3)
    if verts is not None:
        k = 3 * n // 4
        c = verts.reshape(-1, 3, 3).mean(1) if len(verts) % 3 == 0 else verts
        d[:k] = c[r.randint(0, len(c), k)] - o[:k] + r.randn(k, 3) * 0.01
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, tmax, np.float32)


def _assert_arrays(port, jax_arrays, names):
    for k in names:
        a, b = getattr(port, k).numpy(), np.asarray(getattr(jax_arrays, k))
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
        if a.dtype.kind == "f":
            assert b.dtype == np.float32, k


MESHES = {"soup500": lambda: _random_soup(500),
          "soup300": lambda: _random_soup(300, seed=2),
          "blob": lambda: (jmesh.icosphere(2)[0].astype(np.float32), jmesh.icosphere(2)[1])}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_bvh_arrays_equal_the_jax_build(mesh):
    verts, idx = MESHES[mesh]()
    _assert_arrays(tbvh.build_bvh(verts, idx, device="cpu"), jbvh.build_bvh(verts, idx),
                   tbvh.COLUMNS)


@pytest.mark.parametrize("case", [(500, 0, 1, np.inf), (300, 2, 3, 4.0)])
def test_bvh_traversals_match_jax(case):
    """traverse_closest and traverse_any on the soups of
    tests/test_geometry.py against the JAX traversals and the brute force."""
    n_tris, seed, ray_seed, tmax = case
    verts, idx = _random_soup(n_tris, seed=seed)
    jt, tt = _tri_soa(verts, idx), _tri(verts, idx)
    jb, tb = jbvh.build_bvh(verts, idx), tbvh.build_bvh(verts, idx, device="cpu")
    o, d, t_min, t_max = _rays(512, ray_seed, tmax, verts)
    J, T = jnp.asarray, torch.as_tensor
    jh, jt_, ji, jb1, jb2 = (np.asarray(a) for a in jbvh.traverse_closest(
        jb, jt, J(o), J(d), J(t_min), J(t_max)))
    (h, t, i, b1, b2), steps = tbvh.traverse(tb, tt, T(o), T(d), T(t_min), T(t_max),
                                             any_hit=False, return_steps=True)
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(i.numpy()[jh], ji[jh])
    np.testing.assert_allclose(t.numpy()[jh], jt_[jh], rtol=RTOL)
    np.testing.assert_allclose(b1.numpy()[jh], jb1[jh], atol=BARY_ATOL)
    np.testing.assert_allclose(b2.numpy()[jh], jb2[jh], atol=BARY_ATOL)
    assert jh.sum() > 50 and steps > tbvh.CHECK_EVERY
    brute = ttri.intersect_brute(tt, T(o), T(d), T(t_min), T(t_max))
    assert torch.equal(h, brute[0])
    for a, b in zip((t, i, b1, b2), brute[1:]):
        assert torch.equal(a[h], b[h])
    occ = tbvh.traverse_any(tb, tt, T(o), T(d), T(t_min), T(t_max)).numpy()
    jocc = np.asarray(jbvh.traverse_any(jb, jt, J(o), J(d), J(t_min), J(t_max)))
    np.testing.assert_array_equal(occ, jocc)
    np.testing.assert_array_equal(occ, ttri.occluded_brute(tt, T(o), T(d), T(t_min),
                                                          T(t_max)).numpy())


def test_scene_bvh_branch():
    """A scene with BVHArrays and no clusters traces through the BVH
    (closest, any and fused), the same hits as the brute force; a short
    t_max leaves shadow rays unoccluded (tests/test_geometry.py)."""
    import dataclasses
    from pbrt_tpu_torch.scenes import cornell_spheres
    brute = cornell_spheres(device="cpu", clusters=False)
    tri = brute.tri
    scene = dataclasses.replace(brute, bvh=tbvh.build_bvh(tri.positions.numpy(),
                                                          tri.indices.numpy(), device="cpu"))
    r = np.random.RandomState(4)
    o = torch.as_tensor(r.uniform(0.1, 0.9, (256, 3)) * [1, 1, -1], dtype=torch.float32)
    d = torch.nn.functional.normalize(torch.as_tensor(r.randn(256, 3), dtype=torch.float32),
                                      dim=-1)
    tm = torch.full((256,), 0.3)
    (h, occ), (hb, occ_b) = (tscene.intersect_occluded(s, o, d, o, d.flip(0), tm)
                             for s in (scene, brute))
    for k in ("valid", "prim_id", "prim_kind", "material_id"):
        assert torch.equal(getattr(h, k), getattr(hb, k)), k
    assert torch.equal(occ, occ_b) and occ.any() and not occ.all()
    assert torch.allclose(h.t, hb.t, rtol=RTOL)
    occ = tscene.occluded(scene, o, d, t_max=torch.full((256,), 1e-3))
    assert not occ.any()


@pytest.mark.parametrize("mesh", ["soup300", "blob"])
def test_kdtree_matches_jax(mesh):
    verts, idx = MESHES[mesh]()
    jk, tk = jkd.build_kdtree(verts, idx), tkd.build_kdtree(verts, idx, device="cpu")
    _assert_arrays(tk, jk, tkd.COLUMNS)
    jt, tt = _tri_soa(verts, idx), _tri(verts, idx)
    o, d, t_min, t_max = _rays(256, 12, verts=verts)
    if mesh == "blob":        # rays from around the sphere, toward it
        o = o / 10.0 * 4.0 - 2.0
        d = (-o + np.random.RandomState(5).randn(256, 3) * 0.4).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    J, T = jnp.asarray, torch.as_tensor
    jh, jt_, ji, _, _ = (np.asarray(a) for a in jkd.traverse_closest(
        jk, jt, J(o), J(d), J(t_min), J(t_max)))
    h, t, i, _, _ = tkd.traverse_closest(tk, tt, T(o), T(d), T(t_min), T(t_max))
    np.testing.assert_array_equal(h.numpy(), jh)
    np.testing.assert_array_equal(i.numpy()[jh], ji[jh])
    np.testing.assert_allclose(t.numpy()[jh], jt_[jh], rtol=RTOL)
    assert jh.sum() > 50
    bh, bt = ttri.intersect_brute(tt, T(o), T(d), T(t_min), T(t_max))[:2]
    np.testing.assert_array_equal(h.numpy(), bh.numpy())
    np.testing.assert_allclose(t.numpy()[jh], bt.numpy()[jh], rtol=1e-4)


@pytest.mark.parametrize("case", [("icosphere", 2), ("open_quad", 3), ("tetra", 1)])
def test_loop_subdivide_bit_for_bit(case):
    name, levels = case
    if name == "icosphere":
        v, f = jmesh.icosphere(1)
    elif name == "open_quad":     # boundary edges and vertices
        v = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0.2], [0, 1, 0]], np.float32)
        f = np.array([[0, 1, 2], [0, 2, 3]])
    else:
        v = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], np.float32)
        f = np.array([[0, 1, 2], [0, 3, 1], [0, 2, 3], [1, 3, 2]])
    tv, tf = tsub.loop_subdivide(v, f, levels)
    jv, jf = jsub.loop_subdivide(v, f, levels)
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(tf, jf)
    if name == "icosphere":
        assert len(tf) == 1280


@pytest.mark.parametrize("kind", ["cylinder", "flat"])
def test_tessellate_curve_bit_for_bit(kind):
    cp = np.array([[0, 0, 0], [0.3, 0.5, 0.1], [0.7, 0.4, -0.2], [1, 1, 0.3]])
    for args in ((0.1, 0.02), (0.05, 0.05, 8, 6)):
        tv, tf = tsub.tessellate_curve(cp, *args, curve_type=kind)
        jv, jf = jsub.tessellate_curve(cp, *args, curve_type=kind)
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
        np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("light", ["point", "area"])
def test_oracle_bit_for_bit(light):
    """The port's oracle on the bridged scene and camera equals the JAX
    package's oracle bit for bit; the port's direct render passes the
    pixel check against it."""
    res, spp = 16, 2
    js, jcam = jcornell_spheres(light=light), jcornell_camera((res, res))
    ts = bridge.scene_from_numpy(scene_tree(js), "cpu", tile=256)
    tcam = bridge.camera_from_numpy(camera_dict(jcam), "cpu")
    ij = joracle.render_direct(js, jcam, res, res, spp, seed=0)
    it = toracle.render_direct(ts, tcam, res, res, spp, seed=0)
    assert it.dtype == ij.dtype
    np.testing.assert_array_equal(it.view(np.int32), ij.view(np.int32))
    cfg = tdriver.RenderConfig(width=res, height=res, spp=spp,
                               sampler=tsmp.SamplerConfig(kind="random", spp=spp, seed=0))
    img = tdriver.render(ts, tcam, cfg, tdirect.make_li(cfg)).numpy()
    _check(img, it)
