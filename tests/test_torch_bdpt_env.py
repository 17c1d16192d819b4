"""The PyTorch port's bidirectional path tracer against pbrt_tpu on the
env-lit Cornell box (no ceiling, the sky's infinite light): escaped
camera subpaths, the infinite light's NEE and its light subpaths with
their density corrections. 8×8, 2 spp, depth 2, random sampler; the image
held as tests/test_torch_bdpt.py holds the area-lit box's (rtol 1e-4, atol
1e-6 and the pixel check). The strategy sums are the port's alone: the
reference's debug_strategies fails on an env-lit scene (its dict mixes
("env0", t) and (s, t) keys, which JAX cannot sort as a pytree); they
are checked to add up to the image."""
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_torch_bdpt import RES, check_bdpt
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import scenes as tscenes


def test_bdpt_env_light_matches_jax():
    strat = check_bdpt(jcornell_spheres(light="env"),
                       tscenes.cornell_spheres(False, "env", "cpu", tile=256),
                       jcornell_camera((RES, RES)), tscenes.cornell_camera((RES, RES), "cpu"),
                       2, jax_strategies=False)
    # escapes at both depths, light sampling, a connection and a splat carry light
    assert all(strat[k][0] > 0 for k in (("env0", 2), ("env0", 3), (1, 2), (2, 2), (2, 1)))
