"""The PyTorch port's volumetric path tracer vs the JAX package and
against physics (baseline config 4: scenes/volumetric.py).

- Config 4's fog box, 32×32, 4 spp, depth 5, zerotwo, and its smoke
  variant (the grid medium), 16×16, 2 spp: the port's native scene (its
  one cluster through the plain versions of the kernels) against the JAX
  scene (brute force), the pixel check of tests/test_oracle.py.
- A σ = 0 medium: volpath equals the port's own path.li without
  compaction (rtol 1e-4, atol 1e-5, as tests/test_integrators.py).
- A pure-scattering furnace in a white environment renders 1 ± 2%
  (tests/test_integrators.py), and a vacuum glass sphere in fog is
  brighter by exp(σ·chord) (tests/test_emission_media.py), both on
  shape-less or quadric-only scenes.
- The native fog and smoke scenes equal the bridged JAX ones, array for
  array.
- A smoke render with the tracking loops' early stop equals the render
  with every walk run to 256 steps, bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import driver as jdriver, volpath as jvolpath
from scenes.volumetric import fog_scene as jfog_scene, smoke_scene as jsmoke_scene
from scenes.volumetric import volumetric_camera as jcamera
from tests.test_oracle import _check
from tests.test_torch_shade import scene_tree
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import samplers as tsmp, transform as ttf
from pbrt_tpu_torch.integrate import driver as tdriver, path as tpath, volpath as tvolpath
from pbrt_tpu_torch.shade import media as tmed


def _cfgs(res, spp, depth=5, kind="zerotwo"):
    return [m.RenderConfig(width=res, height=res, spp=spp, max_depth=depth,
                           sampler=s.SamplerConfig(kind=kind, spp=spp))
            for m, s in ((jdriver, jsmp), (tdriver, tsmp))]


def _port(scene, cam, cfg, li=tvolpath.make_li):
    img, stats = tdriver.render(scene, cam, cfg, li(cfg, return_stats=True))
    img = img.numpy()
    assert np.isfinite(img).all() and float(stats["rays_traced"]) >= cfg.width ** 2 * cfg.spp
    return img


@pytest.mark.parametrize("variant,res,spp", [("fog", 32, 4), ("smoke", 16, 2)])
def test_config4_matches_jax(variant, res, spp):
    jcfg, tcfg = _cfgs(res, spp)
    js = jfog_scene() if variant == "fog" else jsmoke_scene()
    ts = (tscenes.fog_scene if variant == "fog" else tscenes.smoke_scene)(device="cpu",
                                                                           tile=256)
    assert ts.media.kinds_present == js.media.kinds_present
    img_j = np.asarray(jdriver.render(js, jcamera((res, res)), jcfg, jvolpath.make_li(jcfg)))
    img_t = _port(ts, tscenes.volumetric_camera((res, res), "cpu"), tcfg)
    assert img_t.mean() > 0.1
    _check(img_t, img_j)


def test_vacuum_medium_equals_path():
    """σ = 0: no medium event, every weight 1, so volpath's surface stream
    is path.li's (same sample dims, same estimator)."""
    _, cfg = _cfgs(16, 2, depth=3)
    scene = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    cam = tscenes.cornell_camera((16, 16), "cpu")
    vac = tmed.build_media([dict(kind=tmed.MEDIUM_HOMOGENEOUS, sigma_a=(0.0,) * 3,
                                 sigma_s=(0.0,) * 3)], device="cpu")
    img_v = _port(dataclasses.replace(scene, media=vac), cam, cfg)
    img_p = tdriver.render(scene, cam, cfg, tpath.make_li(cfg)).numpy()
    np.testing.assert_allclose(img_v, img_p, rtol=1e-4, atol=1e-5)


def test_scattering_furnace():
    """Albedo-1 medium in a uniform environment, no shapes: L = Le."""
    b = tscenes._Builder()
    b.infinite_light(radiance=1.0)
    b.set_homogeneous_medium(sigma_a=(0.0,) * 3, sigma_s=(0.4,) * 3, g=0.0)
    scene = b.build("cpu", 256)
    assert scene.tri.count == 0 and scene.clusters is None and scene.world_radius == 1.0
    cam = tcam.make_perspective(ttf.look_at_np([0., 0., 0.], [0., 0., -1.], [0., 1., 0.]),
                                60.0, (12, 12), "cpu")
    _, cfg = _cfgs(12, 32, depth=8)
    img = _port(scene, cam, cfg)
    np.testing.assert_allclose(img.mean(), 1.0, rtol=0.02)


def test_two_media_interface():
    """A glass sphere (eta 1) with a vacuum interior in absorbing fog: the
    center pixels are brighter than with fog inside by about exp(σ·2r)."""
    sigma, radius = 0.4, 0.8

    def build(inside):
        b = tscenes._Builder()
        glass = b.glass(kr=0.0, kt=1.0, eta=1.0)
        b.medium_interface(glass, inside=inside, outside=0)
        b.add_sphere((0.0, 0.0, 0.0), radius, glass)
        b.set_homogeneous_medium(sigma_a=(sigma,) * 3, sigma_s=(0.0,) * 3)
        b.infinite_light(radiance=1.0)
        return b.build("cpu", 256)

    cam = tcam.make_perspective(ttf.look_at_np([0., 0., -3.], [0., 0., 0.], [0., 1., 0.]),
                                35.0, (32, 32), "cpu")
    _, cfg = _cfgs(32, 8, depth=6, kind="stratified")
    scene = build(-1)
    assert scene.materials.med_inside.tolist() == [-1]
    img_vac, img_fog = _port(scene, cam, cfg), _port(build(0), cam, cfg)
    c_vac, c_fog = img_vac[14:18, 14:18].mean(), img_fog[14:18, 14:18].mean()
    expected = np.exp(sigma * 2.0 * radius)
    assert c_vac > c_fog * (1.0 + 0.4 * (expected - 1.0)), (c_vac, c_fog)
    np.testing.assert_allclose(c_vac / max(c_fog, 1e-9), expected, rtol=0.25)


@pytest.mark.parametrize("variant", ["fog", "smoke"])
def test_native_config4_scene_equals_the_bridged_jax_scene(variant):
    jmake, tmake = {"fog": (jfog_scene, tscenes.fog_scene),
                    "smoke": (jsmoke_scene, tscenes.smoke_scene)}[variant]
    via_bridge = bridge.scene_from_numpy(scene_tree(jmake()), "cpu")
    native = tmake(device="cpu")
    for part in ("tri", "quad", "materials", "lights", "media"):
        a, b = getattr(native, part), getattr(via_bridge, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name == "env_dist":     # no env light: the placeholder distribution
                for d1 in ("conditional", "marginal"):
                    for k in ("func", "cdf", "func_int"):
                        assert torch.equal(getattr(getattr(x, d1), k), getattr(getattr(y, d1), k))
            elif torch.is_tensor(x):
                assert x.dtype == y.dtype and torch.equal(x, y), (part, f.name)
            else:
                assert x == y, (part, f.name)
    assert native.media.kinds_present == ((tmed.MEDIUM_HOMOGENEOUS,) if variant == "fog"
                                          else (tmed.MEDIUM_GRID,))
    assert torch.equal(native.world_center, via_bridge.world_center)
    assert native.world_radius == via_bridge.world_radius


def test_tracking_early_stop_equals_full_walks(monkeypatch):
    _, cfg = _cfgs(8, 1)
    scene = tscenes.smoke_scene(device="cpu", tile=256)
    cam = tscenes.volumetric_camera((8, 8), "cpu")
    imgs, steps = [], []
    for check in (tmed.CHECK_EVERY, tmed.MAX_TRACK_STEPS + 1):
        monkeypatch.setattr(tmed, "CHECK_EVERY", check)
        before = tmed.TRACKED.steps
        imgs.append(tdriver.render(scene, cam, cfg, tvolpath.make_li(cfg)))
        steps.append(tmed.TRACKED.steps - before)
    assert torch.equal(imgs[0], imgs[1]) and float(imgs[0].mean()) > 0.05
    assert steps[1] == 16 * tmed.MAX_TRACK_STEPS and steps[0] < steps[1] // 4
