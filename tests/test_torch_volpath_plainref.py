"""The port's volumetric path tracer against the benchmark's plain
reference (benchmark/plainref/volpath.py: PBRT-v3's VolPathIntegrator
with a scene-wide homogeneous medium, written from its definition).

- Config 4's fog box (benchmark/configs/fog_box.json, the port's
  scenes.fog_scene) at 16×16, 2 spp, depth 5, zerotwo: the port's
  render against the reference's with the pixel check of
  tests/test_oracle.py, in the configuration's own medium and in four
  seeded random media (σa, σs per channel in [0.02, 1.5], g in
  [−0.6, 0.8]).
- With σa = σs = 0 the reference equals the plain path tracer without
  compaction (rtol 1e-4, atol 1e-5, as tests/test_torch_volpath.py holds
  the port's own σ = 0 render to path.li).
- The reference's HG sample leans along the ray by g: the mean cosine of
  wi with the ray's direction is g."""
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests.test_oracle import _check
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.film import filters
from pbrt_tpu_torch.integrate import driver, volpath as tvolpath

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
sys.path.append(BENCH)

from plainref import path as ppath, scene as pscene, volpath as pvol  # noqa: E402

RES, SPP, DEPTH, RR_START, SEED = 16, 2, 5, 3, 2_718_281_829
with open(os.path.join(BENCH, "configs", "fog_box.json")) as f:
    CONF = json.load(f)


def _random_medium(k):
    r = np.random.RandomState(1000 + k)
    return dict(kind="homogeneous", sigma_a=r.uniform(0.02, 1.5, 3).tolist(),
                sigma_s=r.uniform(0.02, 1.5, 3).tolist(), g=float(r.uniform(-0.6, 0.8)))


MEDIA = [CONF["medium"]] + [_random_medium(k) for k in range(4)]


def _reference(med, fn=None):
    conf = dict(CONF, medium=med)
    sc = pscene.build(conf, "cpu")
    cam = pscene.camera(conf, RES, RES, "cpu")
    if fn is not None:
        return fn(sc, cam)
    return pvol.render(sc, cam, pvol.medium(conf, "cpu"), SPP, SEED, DEPTH, RR_START,
                       pvol.world_radius(conf)).numpy()


@pytest.mark.parametrize("med", MEDIA, ids=["config", "random0", "random1", "random2",
                                            "random3"])
def test_port_matches_the_plain_reference(med):
    scene = tscenes.fog_scene(tuple(med["sigma_a"]), tuple(med["sigma_s"]), med["g"],
                              device="cpu", tile=256)
    assert scene.world_radius == pvol.world_radius(CONF)
    cam = tscenes.volumetric_camera((RES, RES), "cpu")
    cfg = driver.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=DEPTH,
                              sampler=tsmp.SamplerConfig(kind="zerotwo", spp=SPP, seed=SEED),
                              filter=filters.Filter("box", radius=0.5))
    img = driver.render(scene, cam, cfg, tvolpath.make_li(cfg, rr_start=RR_START)).numpy()
    ref = _reference(med)
    assert np.isfinite(img).all() and img.mean() > 0.01
    _check(img, ref)


def test_a_vacuum_reference_is_the_plain_path_tracer():
    vac = dict(kind="homogeneous", sigma_a=[0.0] * 3, sigma_s=[0.0] * 3, g=0.0)
    img_v = _reference(vac)
    img_p = _reference(vac, lambda sc, cam: ppath.render(
        sc, cam, SPP, SEED, DEPTH, RR_START, None).numpy())
    assert img_p.mean() > 0.05
    np.testing.assert_allclose(img_v, img_p, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("g", [-0.4, 0.0, 0.6])
def test_the_phase_sample_leans_along_the_ray_by_g(g):
    n = 200_000
    gen = torch.Generator().manual_seed(7)
    d = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    wi, pdf = pvol.hg_sample(-d, g, torch.rand(n, 2, generator=gen))
    assert torch.allclose(wi.norm(dim=-1), torch.ones(n), atol=1e-5)
    assert float((wi * d).sum(-1).mean()) == pytest.approx(g, abs=0.01)
    assert torch.allclose(pdf, pvol.hg((wi * -d).sum(-1), g), rtol=1e-3, atol=1e-6)
