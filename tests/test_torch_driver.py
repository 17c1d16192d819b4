"""The driver's film accumulation: driver.render reduces each batch of
samples to per-pixel sums and adds them to the film, as pbrt_tpu's does.

Config 2's batching (16-spp wavefronts; the specular Cornell box, path at
depth 5, zerotwo) at 16×16, two batches: against pbrt_tpu's
driver.render, the pixel check of tests/test_oracle.py; and bit for bit
against the sums of the same batches added in the reference's order (so
the memory of a render no longer grows with spp). The JAX side renders op
by op (jit=False): compiling each batch's wavefront takes longer."""
import numpy as np
import torch

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import driver as jdriver, path as jpath
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_media import one_torch_thread  # noqa: F401

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.integrate import driver as tdriver, path as tpath
from pbrt_tpu_torch.scenes import CORNELL_SPP_BATCH

RES, SPP = 16, 2 * CORNELL_SPP_BATCH


def test_multi_batch_render_matches_jax():
    jcfg, tcfg = [m.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=5,
                                 samples_per_batch=CORNELL_SPP_BATCH,
                                 sampler=s.SamplerConfig(kind="zerotwo", spp=SPP))
                  for m, s in ((jdriver, jsmp), (tdriver, tsmp))]
    scene = tscenes.cornell_spheres(True, "area", "cpu", tile=256)
    cam = tscenes.cornell_camera((RES, RES), "cpu")
    li = tpath.make_li(tcfg)
    img_t = tdriver.render(scene, cam, tcfg, li)

    acc = torch.zeros((RES, RES, 3))
    wacc = torch.zeros((RES, RES))
    for lo in range(0, SPP, CORNELL_SPP_BATCH):
        a, b = tfilm.sums(*tdriver.render_batch(scene, cam, tcfg, li, lo,
                                                lo + CORNELL_SPP_BATCH), RES, RES)
        acc, wacc = acc + a, wacc + b
    assert torch.equal(img_t, tfilm.resolve(acc, wacc))

    img_j = np.asarray(jdriver.render(jcornell_spheres(specular=True),
                                      jcornell_camera((RES, RES)), jcfg,
                                      jpath.make_li(jcfg), jit=False))
    img_t = img_t.numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.1
    _check(img_t, img_j)
