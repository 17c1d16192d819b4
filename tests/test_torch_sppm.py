"""The PyTorch port's stochastic progressive photon mapping against
pbrt_tpu on the matte Cornell box with its area light: 8×8, 2 iterations
of 1,024 photons, depth 3, random sampler, the port's native scene (its
one cluster through the plain versions of the kernels) against the JAX
scene (brute force).

Held: the dense gather's image here, the hash grid's with
max_photons_per_cell=2 (so the cap drops photons) in
tests/test_torch_sppm_grid.py, per pixel at rtol 1e-4, atol 1e-6 and by
the pixel check of tests/test_oracle.py; photons_dropped equal (0 for the
dense gather). The reference's render runs with its jitted iteration
compiled once (tests/test_torch_bdpt.reference_jit), one compile a file.
Torch runs on one thread."""
import numpy as np

from pbrt_tpu.integrate import sppm as jsppm
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.integrate import sppm as tsppm

RES = 8


def check_sppm(gather, cap):
    js, jcam = jcornell_spheres(light="area"), jcornell_camera((RES, RES))
    ts = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    tcam = tscenes.cornell_camera((RES, RES), "cpu")
    jcfg = jsppm.SPPMConfig(width=RES, height=RES, n_iterations=2, photons_per_iter=1024,
                            max_depth=3, gather=gather, max_photons_per_cell=cap,
                            return_stats=True)
    tcfg = bridge.sppm_config(jcfg)
    assert tsppm.gather_method(tcfg) == gather
    with reference_jit():
        img_j, stats_j = jsppm.render(js, jcam, jcfg)
    img_t, stats_t = tsppm.render(ts, tcam, tcfg)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.05
    np.testing.assert_allclose(img_t, img_j, rtol=1e-4, atol=1e-6)
    _check(img_t, img_j)
    assert stats_t["photons_dropped"] == stats_j["photons_dropped"]
    assert (stats_t["photons_dropped"] > 0) == (gather == "grid")
    assert float(stats_t["rays_traced"]) > RES * RES * 2


def test_sppm_dense_matches_jax():
    check_sppm("dense", 32)
