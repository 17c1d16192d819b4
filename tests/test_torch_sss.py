"""Subsurface scattering through the PyTorch port against pbrt_tpu.

- The beam-diffusion profile table bit for bit (8×16 at two media).
- sample_exit on the plane scene of tests/test_sss.py: the exit hits, Sp
  weights and flags per lane (both packages' tracers, the JAX scene
  through the bridge), on the same uniforms: the flags on all but 0.5% of
  lanes, and where both found an exit the normal exactly, t at rtol 1e-5,
  the point at atol 2e-5 (each tracer rebuilds it from its barycentrics),
  the Sp weight at rtol 1e-4 (the profile's slope near r = 0 magnifies an
  ulp of the exit point).
- The subsurface ball of tests/test_sss.py through path at 8×8, 2 spp,
  depth 2, zerotwo: the image per pixel at rtol 1e-4, atol 1e-6, and the
  pixel check of tests/test_oracle.py. The JAX render compiles once with
  fewer LLVM passes (tests/test_torch_bdpt.reference_jit).
- The bench scene with a subsurface blob and with a metal blob, built
  natively, equals the JAX scene through the bridge (subdivisions 1).

The JAX package fills a 32×64 profile table in about 13 s: the table is
held bit for bit at 8×16 (the same code at a smaller grid), and the JAX
scenes here take the port's 32×64 table.
Sampled values at most 0.5% of lanes past rtol 1e-5, none past 1e-3, as
in tests/test_torch_bxdf.py. Torch runs on one thread."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.api import SceneBuilder
from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.geom import scene as jscene
from pbrt_tpu.geom.meshio import bench_blob
from pbrt_tpu.integrate import common as jcommon, driver as jdriver, path as jpath
from pbrt_tpu.integrate import path_sss as jsss
from pbrt_tpu.shade import bssrdf as jbss
from scenes.bunny import _wood_image, mesh_scene
from tests.test_oracle import _check
from tests.test_sss import _ball_scene, _plane_scene
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_shade import scene_tree
from tests.test_torch_textures import port_sss_table

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.geom import scene as tscene
from pbrt_tpu_torch.integrate import common as tcommon, driver as tdriver, path as tpath
from pbrt_tpu_torch.integrate import path_sss as tsss
from pbrt_tpu_torch.shade import bssrdf as tbss

JAX_TABLE = jbss.compute_beam_diffusion_table


@pytest.fixture(autouse=True)
def port_table(monkeypatch):
    monkeypatch.setattr(jbss, "compute_beam_diffusion_table", port_sss_table)


@pytest.mark.parametrize("g,eta", [(0.0, 1.33), (0.3, 1.5)])
def test_profile_table_bit_for_bit(g, eta):
    j = JAX_TABLE(g=g, eta=eta, n_rho=8, n_r=16)
    t = tbss.beam_diffusion_table_np(g, eta, 8, 16)
    for k in tbss.FIELDS:
        np.testing.assert_array_equal(t[k], np.asarray(getattr(j, k)), k)


def test_sample_exit_on_the_plane():
    js = _plane_scene((0.1, 0.3, 1.0), (9.9, 9.7, 9.0))
    ts = bridge.scene_from_numpy(scene_tree(js), "cpu")
    n = 2048
    r = np.random.RandomState(7)
    o = np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    o[:, :2] = r.uniform(-2.0, 2.0, (n, 2))
    d = np.tile([0.0, 0.0, -1.0], (n, 1)).astype(np.float32)
    u = [r.rand(n).astype(np.float32) for _ in range(4)]
    is_sss = r.rand(n) < 0.9
    jh = jscene.intersect(js, jnp.asarray(o), jnp.asarray(d))
    th = tscene.intersect(ts, torch.as_tensor(o), torch.as_tensor(d))
    with reference_jit():
        j_out = jax.jit(lambda *a: jsss.sample_exit(js, *a))(
            jh, jcommon.shading_frame(jh, js), *map(jnp.asarray, u), jnp.asarray(is_sss))
    t_out = tsss.sample_exit(ts, th, tcommon.shading_frame(th, ts), *map(torch.as_tensor, u),
                             torch.as_tensor(is_sss))
    (jx, jw, jok, jeta), (tx, tw, tok, teta) = j_out, t_out
    assert (tok.numpy() != np.asarray(jok)).mean() <= 5e-3
    assert tok.sum() > n // 4
    both = tok.numpy() & np.asarray(jok)
    np.testing.assert_array_equal(tx.ns.numpy()[both], np.asarray(jx.ns)[both])
    np.testing.assert_allclose(tx.t.numpy()[both], np.asarray(jx.t)[both], rtol=1e-5)
    np.testing.assert_allclose(tx.p.numpy()[both], np.asarray(jx.p)[both], atol=2e-5)
    np.testing.assert_allclose(tw.numpy()[both], np.asarray(jw)[both], rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(teta.numpy(), np.asarray(jeta))
    assert np.abs(tx.p.numpy()[tok.numpy(), 2]).max() < 1e-3


def test_subsurface_ball_path_matches_jax():
    res, spp = 8, 2
    js = _ball_scene("sss")
    ts = bridge.scene_from_numpy(scene_tree(js), "cpu")
    assert 10 in ts.materials.kinds_present and ts.materials.sss_table is not None
    from pbrt_tpu.cameras import make_perspective
    from pbrt_tpu.core import transform as jtf
    pos, look, up = [0.0, 0.8, 1.8], [0.0, 0.35, 0.0], [0.0, 1.0, 0.0]
    jcam = make_perspective(jtf.look_at(np.array(pos), np.array(look), np.array(up)), 45.0,
                            (res, res))
    tcam_ = tcam.make_perspective(ttf.look_at_np(pos=pos, look=look, up=up), 45.0, (res, res),
                                  "cpu")
    jcfg, tcfg = [m.RenderConfig(width=res, height=res, spp=spp, max_depth=2,
                                 sampler=s.SamplerConfig(kind="zerotwo", spp=spp))
                  for m, s in ((jdriver, jsmp), (tdriver, tsmp))]
    with reference_jit():
        img_j = np.asarray(jdriver.render(js, jcam, jcfg, jpath.make_li(jcfg)))
    img_t = tdriver.render(ts, tcam_, tcfg, tpath.make_li(tcfg)).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.01
    np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-6)
    _check(img_t, img_j)


def jax_bench(blob):
    """scenes/bunny.mesh_scene at subdivisions 1 with the blob's material
    set to SceneBuilder.subsurface() at its defaults."""
    if blob == "metal":
        return mesh_scene(subdivisions=1, use_bvh=True, metal_blob=True)
    b = SceneBuilder()
    white = b.matte(kd=(0.73, 0.73, 0.73))
    wood = b.textures.image(_wood_image(), su=3.0, sv=3.0)
    floor_mat = b.material(kind=0, kd=(1.0, 1.0, 1.0), kd_tex=wood, sigma=0.0)
    blob_mat = b.subsurface()
    v, f, vn = bench_blob(1)
    b.add_mesh(v + np.array([0.5, 0.35, -0.5], np.float32), f, blob_mat, normals=vn)
    s = 1.0
    b.add_quad([0, 0, 0], [s, 0, 0], [s, 0, -s], [0, 0, -s], floor_mat)
    b.add_quad([0, s, 0], [0, s, -s], [s, s, -s], [s, s, 0], white)
    b.add_quad([0, 0, -s], [s, 0, -s], [s, s, -s], [0, s, -s], white)
    e, c, y = 0.25, s / 2, s - 1e-3
    b.area_light_quad([c - e, y, -c + e], [c - e, y, -c - e], [c + e, y, -c - e],
                      [c + e, y, -c + e], radiance=(14.0, 14.0, 14.0))
    b.use_bvh = True
    return b.build()


def assert_same_scene(native, via_bridge, parts=("tri", "materials", "textures", "lights")):
    """Every field of the parts equal, tensors bit for bit; the lights'
    env distributions at rtol 1e-6 (cumulative sums in different orders)."""
    for part in parts:
        a, b = getattr(native, part), getattr(via_bridge, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "env_dist":
                for d1 in ("conditional", "marginal"):
                    for k in ("func", "cdf", "func_int"):
                        np.testing.assert_allclose(getattr(getattr(x, d1), k).numpy(),
                                                   getattr(getattr(y, d1), k).numpy(),
                                                   rtol=1e-6, atol=1e-7)
            elif torch.is_tensor(x):
                assert x.dtype == y.dtype and torch.equal(x, y), (part, f.name)
            elif dataclasses.is_dataclass(x):
                for g in dataclasses.fields(x):
                    u, v = getattr(x, g.name), getattr(y, g.name)
                    assert torch.equal(u, v) if torch.is_tensor(u) else u == v, (part, f.name)
            else:
                assert x == y, (part, f.name)
    assert torch.equal(native.world_center, via_bridge.world_center)
    assert native.world_radius == via_bridge.world_radius


@pytest.mark.parametrize("blob", ["subsurface", "metal"])
def test_bench_scene_blob_equals_the_bridged_jax_scene(blob):
    native = tscenes.bench_scene(1, "cpu", blob=blob)
    assert_same_scene(native, bridge.scene_from_numpy(scene_tree(jax_bench(blob)), "cpu"))
    kind = {"subsurface": 10, "metal": 3}[blob]
    assert native.materials.kinds_present == (0, kind)
    assert (native.materials.sss_table is not None) == (blob == "subsurface")
