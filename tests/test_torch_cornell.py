"""The Cornell box of the baseline configs through the PyTorch port vs
the JAX package and the independent CPU oracle.

- The native scene (pbrt_tpu_torch.scenes.cornell_spheres) equals the
  JAX scene passed through the bridge, array for array, world bounds
  included; its env Distribution2D at rtol 1e-6 (the two packages'
  cumulative sums add in different orders).
- Direct lighting (point, area and env light) and the path tracer at
  depth 5 with the mirror and glass spheres, 32×32, 2 spp, zerotwo: the
  native scene (its one cluster through the plain versions of the
  kernels) against the JAX scene (brute force), the pixel check of
  tests/test_oracle.py. tests/test_torch_options.py renders the other
  sampler kinds and the light strategies.
- The port's direct lighting against oracle/cpu_reference.render_direct
  with the point and the area light, 32×32, 2 spp, random sampler,
  tests/test_oracle.py's _check."""
import dataclasses

import numpy as np
import pytest
import torch

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import direct as jdirect, driver as jdriver, path as jpath
from pbrt_tpu.oracle import cpu_reference as oracle
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver, path as tpath

RES, SPP = 32, 2
VARIANTS = {"area": (False, "area"), "point": (False, "point"), "env": (False, "env"),
            "specular": (True, "area")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_native_scene_equals_the_bridged_jax_scene(variant):
    specular, light = VARIANTS[variant]
    via_bridge = bridge.scene_from_numpy(
        scene_tree(jcornell_spheres(specular=specular, light=light)), "cpu")
    native = tscenes.cornell_spheres(specular, light, "cpu")
    assert native.clusters.n_clusters == 1 and via_bridge.clusters is None
    for part in ("tri", "quad", "materials", "lights"):
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
            else:
                assert x == y, (part, f.name)
    assert torch.equal(native.world_center, via_bridge.world_center)
    assert native.world_radius == via_bridge.world_radius


def render_pair(integrator, specular, light, kind="zerotwo", res=RES, spp=SPP, jit=True):
    """The same Cornell render through the JAX package (compiled, or op
    by op without `jit`) and the port's native scene on the CPU."""
    jcfg, tcfg = [m.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                                 sampler=s.SamplerConfig(kind=kind, spp=spp))
                  for m, s in ((jdriver, jsmp), (tdriver, tsmp))]
    jmod, tmod = (jdirect, tdirect) if integrator == "direct" else (jpath, tpath)
    with reference_jit():
        img_j = np.asarray(jdriver.render(jcornell_spheres(specular=specular, light=light),
                                          jcornell_camera((res, res)), jcfg, jmod.make_li(jcfg),
                                          jit=jit))
    img_t = tdriver.render(tscenes.cornell_spheres(specular, light, "cpu", tile=256),
                           tscenes.cornell_camera((res, res), "cpu"), tcfg,
                           tmod.make_li(tcfg)).numpy()
    assert np.isfinite(img_t).all() and img_t.shape == (res, res, 3)
    assert img_t.mean() > 0.1
    return img_t, img_j


@pytest.mark.parametrize("light", ["point", "area", "env"])
def test_direct_matches_jax(light):
    _check(*render_pair("direct", False, light))


def test_path_with_mirror_and_glass_matches_jax():
    _check(*render_pair("path", True, "area"))


@pytest.mark.parametrize("light", ["point", "area"])
def test_direct_matches_the_oracle(light):
    cfg = tdriver.RenderConfig(width=RES, height=RES, spp=SPP,
                               sampler=tsmp.SamplerConfig(kind="random", spp=SPP, seed=0))
    img_t = tdriver.render(tscenes.cornell_spheres(False, light, "cpu", tile=256),
                           tscenes.cornell_camera((RES, RES), "cpu"), cfg,
                           tdirect.make_li(cfg)).numpy()
    img_o = oracle.render_direct(jcornell_spheres(light=light), jcornell_camera((RES, RES)),
                                 RES, RES, SPP, seed=0)
    _check(img_t, img_o)
