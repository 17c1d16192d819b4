"""The appearance box through the PyTorch port against pbrt_tpu.

- The box built natively (scenes.appearance_box) equals the JAX scene the
  same builder calls make through pbrt_tpu.api.SceneBuilder, through the
  bridge: every material, texture and light array bit for bit.
- Direct lighting of the box (without marble, which the JAX package
  cannot evaluate on more than one lane) at 8×8, 2 spp, zerotwo, bump
  mapping on its back wall: the JAX render op by op (its perlin compiled).
  Pixels whose samples all hit an unbumped surface at rtol 1e-4, atol
  1e-6; pixels that see the bump-mapped wall at rtol 1e-3, atol 1e-5
  (bump mapping differentiates the fbm texture by finite differences of
  5e-4 in float32, which magnifies an ulp of the texture about 2,000×),
  and the pixel check of tests/test_oracle.py over the image.
- Path with aniso_taps = 3 on an image-textured quad at grazing view, 8×8,
  1 spp, depth 1: the image at rtol 1e-4, atol 1e-6.
- A scene with a mix row: neither package renders it.

The JAX scene's BSSRDF table is the port's arrays (tests/test_torch_sss.py
holds them equal bit for bit); direct lighting does not read it. Torch
runs on one thread."""
import numpy as np
import pytest

from pbrt_tpu.api import SceneBuilder
from pbrt_tpu.cameras import make_perspective
from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.integrate import direct as jdirect, driver as jdriver, path as jpath
from pbrt_tpu.shade import bssrdf as jbss
from pbrt_tpu.shade import fourier as jfou
from scenes.cornell import cornell_camera as jcornell_camera
from tests.test_oracle import _check
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_shade import scene_tree
from tests.test_torch_sss import assert_same_scene
from tests.test_torch_textures import jit_perlin, port_sss_table  # noqa: F401 (autouse)

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.api import SceneBuilder as TSceneBuilder
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.geom import scene as tscene
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver, path as tpath
from pbrt_tpu_torch.shade import materials as tmat

RES, SPP = 8, 2


@pytest.fixture(autouse=True)
def port_table(monkeypatch):
    monkeypatch.setattr(jbss, "compute_beam_diffusion_table", port_sss_table)


def jax_box(marble):
    return tscenes.appearance_rows(SceneBuilder(), jfou.make_lambertian_table((0.6, 0.4, 0.3)),
                                   marble).build()


def test_native_box_equals_the_bridged_jax_box():
    native = tscenes.appearance_box("cpu")
    assert native.materials.kinds_present == tuple(k for k in range(13) if k != 9)
    assert native.textures.kinds_present == tuple(range(13))
    assert native.materials.tex_channels == tmat.TEX_CHANNELS and native.materials.has_bump
    via_bridge = bridge.scene_from_numpy(scene_tree(jax_box(True)), "cpu")
    assert_same_scene(native, via_bridge, ("tri", "quad", "materials", "textures", "lights"))


def cfgs(**kw):
    return [m.RenderConfig(width=RES, height=RES, spp=SPP,
                           sampler=s.SamplerConfig(kind="zerotwo", spp=SPP), **kw)
            for m, s in ((jdriver, jsmp), (tdriver, tsmp))]


def test_direct_on_the_box_matches_jax():
    jcfg, tcfg = cfgs(max_depth=5)
    ts = tscenes.appearance_box("cpu", marble=False)
    tcam_ = tscenes.cornell_camera((RES, RES), "cpu")
    img_j = np.asarray(jdriver.render(jax_box(False), jcornell_camera((RES, RES)), jcfg,
                                      jdirect.make_li(jcfg), jit=False))
    img_t = tdriver.render(ts, tcam_, tcfg, tdirect.make_li(tcfg)).numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.05
    # the pixels whose camera samples hit a bump-mapped surface
    pid, sid = tdriver.lane_ids(tcfg, 0, SPP, "cpu")
    o, d, _, _ = tdriver.camera_rays(tcam_, tcfg, pid, sid)
    hit = tscene.intersect(ts, o.reshape(-1, 3), d.reshape(-1, 3))
    bumped = (hit.valid & (ts.materials.bump_tex[hit.material_id.clamp(min=0)] >= 0))
    bumped = bumped.reshape(SPP, RES, RES).any(0).numpy()
    assert 0 < bumped.sum() < RES * RES
    np.testing.assert_allclose(img_t[~bumped], img_j[~bumped], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(img_t[bumped], img_j[bumped], rtol=1e-3, atol=1e-5)
    _check(img_t, img_j)


def textured_quad(b):
    tid = b.textures.image(tscenes.wood_image(64), su=4.0, sv=4.0)
    floor = b.material(kind=tmat.MAT_MATTE, kd=(1.0, 1.0, 1.0), kd_tex=tid)
    b.add_quad([-2, 0, 1], [2, 0, 1], [2, 0, -6], [-2, 0, -6], floor)
    b.area_light_quad([-0.5, 2, -1.5], [0.5, 2, -1.5], [0.5, 2, -0.5], [-0.5, 2, -0.5],
                      (10.0, 10.0, 10.0))
    return b


def test_aniso_taps_match_jax():
    jcfg, tcfg = cfgs(max_depth=1, aniso_taps=3)
    assert tcfg.aniso_taps == 3 == jcfg.aniso_taps
    pos, look, up = [0.0, 0.3, 1.0], [0.0, 0.0, -3.0], [0.0, 1.0, 0.0]
    jcam = make_perspective(jtf.look_at(np.array(pos), np.array(look), np.array(up)), 50.0,
                            (RES, RES))
    tcam_ = tcam.make_perspective(ttf.look_at_np(pos=pos, look=look, up=up), 50.0, (RES, RES),
                                  "cpu")
    js = textured_quad(SceneBuilder()).build()
    ts = textured_quad(TSceneBuilder()).build(True, "cpu", 256)
    with reference_jit():
        img_j = np.asarray(jdriver.render(js, jcam, jcfg, jpath.make_li(jcfg, camera=jcam)))
    img_t = tdriver.render(ts, tcam_, tcfg, tpath.make_li(tcfg, camera=tcam_)).numpy()
    assert img_t.mean() > 0.05
    np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-6)
    one_cfg = tcfg._replace(aniso_taps=1)
    one = tdriver.render(ts, tcam_, one_cfg, tpath.make_li(one_cfg, camera=tcam_)).numpy()
    assert not np.array_equal(one, img_t)      # the taps filter differently


def mix_scene(b):
    m1 = b.matte(kd=(0.8, 0.2, 0.2))
    m2 = b.matte(kd=(0.2, 0.2, 0.8))
    mix = b.material(kind=tmat.MAT_MIX, kd=0.5, aux=(m1, m2, 0, 0, 0, 0, 0, 0))
    b.add_quad([0, 0, 0], [1, 0, 0], [1, 0, -1], [0, 0, -1], mix)
    b.point_light([0.5, 0.8, -0.5], (1.0, 1.0, 1.0))
    return b


def test_a_mix_row_cannot_render():
    jcfg, tcfg = cfgs(max_depth=2)
    with pytest.raises(KeyError), reference_jit():     # raised while tracing
        jdriver.render(mix_scene(SceneBuilder()).build(), jcornell_camera((RES, RES)), jcfg,
                       jdirect.make_li(jcfg))
    ts = mix_scene(TSceneBuilder()).build(True, "cpu", 256)
    for mod in (tdirect, tpath):
        with pytest.raises(ValueError, match="mix"):
            tdriver.render(ts, tscenes.cornell_camera((RES, RES), "cpu"), tcfg,
                           mod.make_li(tcfg))
