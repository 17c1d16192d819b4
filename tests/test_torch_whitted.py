"""The PyTorch port's Whitted integrator vs the JAX package on baseline
config 2's Cornell box (a mirror and a glass sphere): 32×32, 2 spp, depth
5, zerotwo, the native scene (its one cluster through the plain versions
of the kernels) against the JAX scene (brute force), the pixel check of
tests/test_oracle.py; then the launches it makes: one closest-hit and one
any-hit trace per light row at every depth."""
import numpy as np

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import driver as jdriver, whitted as jwhitted
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.geom import cluster as tcl
from pbrt_tpu_torch.integrate import driver as tdriver, whitted as twhitted

RES, SPP, DEPTH = 32, 2, 5


def test_whitted_on_the_specular_cornell_box_matches_jax(monkeypatch):
    jcfg, tcfg = [m.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=DEPTH,
                                 sampler=s.SamplerConfig(kind="zerotwo", spp=SPP))
                  for m, s in ((jdriver, jsmp), (tdriver, tsmp))]
    img_j = np.asarray(jdriver.render(jcornell_spheres(specular=True),
                                      jcornell_camera((RES, RES)), jcfg,
                                      jwhitted.make_li(jcfg)))
    scene = tscenes.cornell_spheres(True, "area", "cpu", tile=256)
    traced = []
    real_trace, real_occ = tcl._trace, tcl.occluded
    monkeypatch.setattr(tcl, "_trace", lambda *a, **k: (traced.append("closest"),
                                                        real_trace(*a, **k))[1])
    monkeypatch.setattr(tcl, "occluded", lambda *a, **k: (traced.append("occluded"),
                                                          real_occ(*a, **k))[1])
    img_t, stats = tdriver.render(scene, tscenes.cornell_camera((RES, RES), "cpu"), tcfg,
                                  twhitted.make_li(tcfg, return_stats=True))
    img_t = img_t.numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.1
    assert traced == (["closest"] + ["occluded"] * scene.lights.count) * DEPTH
    assert RES * RES * SPP < float(stats["rays_traced"]) < RES * RES * SPP * DEPTH * 2
    _check(img_t, img_j)
