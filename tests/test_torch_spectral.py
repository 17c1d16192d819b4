"""The PyTorch port's spectral render mode against pbrt_tpu:
render_spectral of the matte Cornell box through path.li, 8×8, 2 spp,
depth 2, 12 bins (four RGB renders of three bins each), random sampler.
Held: each spectralised scene's reflectances and emissions at rtol 1e-6
(atol 1e-7), the (H, W, 12) stack and the RGB image per pixel at rtol
1e-4, atol 1e-6, and the pixel check of tests/test_oracle.py.

The reference's render_spectral runs as written; its four renders differ
only in the scene's arrays, so its driver's render is traced and compiled
once (fewer LLVM passes, tests/test_torch_bdpt.JAX_COMPILE) and called
four times. Torch runs on one thread."""
import jax
import numpy as np

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import driver as jdriver, path as jpath, spectral as jspectral
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_bdpt import JAX_COMPILE
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.integrate import driver as tdriver, path as tpath, spectral as tspectral

RES, SPP, BINS = 8, 2, 12


def test_spectral_matches_jax(monkeypatch):
    js, jcam = jcornell_spheres(light="area"), jcornell_camera((RES, RES))
    ts = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    jcfg = jdriver.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=2,
                                sampler=jsmp.SamplerConfig(kind="random", spp=SPP))
    tcfg = tdriver.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=2,
                                sampler=tsmp.SamplerConfig(kind="random", spp=SPP))
    for k in range(0, BINS, 3):
        sj = jspectral._spectralize_scene(js, slice(k, k + 3), BINS)
        st = tspectral._spectralize_scene(ts, slice(k, k + 3), BINS)
        for name in ("kd", "ks", "kr", "kt"):
            np.testing.assert_allclose(getattr(st.materials, name).numpy(),
                                       np.asarray(getattr(sj.materials, name)),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
        for name in ("emit", "env_image"):
            np.testing.assert_allclose(getattr(st.lights, name).numpy(),
                                       np.asarray(getattr(sj.lights, name)),
                                       rtol=1e-6, atol=1e-7, err_msg=name)

    compiled, real_render = {}, jdriver.render

    def render_once(scene, camera, cfg, li_fn):
        if not compiled:
            compiled[0] = jax.jit(lambda sc: real_render(sc, camera, cfg, li_fn, jit=False)) \
                .lower(scene).compile(JAX_COMPILE)
        return compiled[0](scene)

    monkeypatch.setattr(jspectral.drivermod, "render", render_once)
    sp_j, rgb_j = (np.asarray(a) for a in jspectral.render_spectral(js, jcam, jcfg,
                                                                   jpath.make_li, BINS))
    sp_t, rgb_t, stats = tspectral.render_spectral(
        ts, tscenes.cornell_camera((RES, RES), "cpu"), tcfg,
        lambda c: tpath.make_li(c, return_stats=True), BINS)
    sp_t, rgb_t = sp_t.numpy(), rgb_t.numpy()
    assert sp_t.shape == (RES, RES, BINS) and np.isfinite(rgb_t).all() and rgb_t.mean() > 0.05
    np.testing.assert_allclose(sp_t, sp_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(rgb_t, rgb_j, rtol=1e-4, atol=1e-6)
    _check(rgb_t, rgb_j)
    assert float(stats["rays_traced"]) >= 4 * RES * RES * SPP
