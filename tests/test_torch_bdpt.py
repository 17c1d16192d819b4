"""The PyTorch port's bidirectional path tracer against pbrt_tpu.

The matte Cornell box with its area light at depth 3, 8×8, 2 spp,
random sampler: the port's native scene (its one cluster through the
plain versions of the kernels) against the JAX scene (brute force) on
the same sample streams. Held: the image per pixel at rtol 1e-4, atol
1e-6, and the pixel check of tests/test_oracle.py; the weighted and
unweighted sums of every (s, t) strategy (debug_strategies) at rtol 1e-4
(atol 1e-7 for sums that are zero on both sides). The env-lit box is
tests/test_torch_bdpt_env.py, the fog box tests/test_torch_bdpt_media.py
(one reference compile a file: each takes 20-40 s).

The JAX reference runs its own render with every jax.jit inside it
compiled once, with fewer LLVM passes (`reference_jit`: the same
functions, a shorter compile). Torch runs on one thread."""
import contextlib

import jax
import numpy as np
import pytest

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import bdpt as jbdpt
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.integrate import bdpt as tbdpt

RES, SPP = 8, 2
RTOL, ATOL = 1e-4, 1e-6
# fewer LLVM passes: the same function, a shorter compile
JAX_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@contextlib.contextmanager
def reference_jit():
    """Inside the block, every jax.jit compiles with JAX_COMPILE, once per
    argument structure and shapes, so the reference's own render runs as
    written (its jitted steps are lowered and compiled explicitly)."""
    real = jax.jit

    def jit(fun=None, **kw):
        if fun is None:
            return lambda f: jit(f, **kw)
        jitted, cache = real(fun, **kw), {}

        def call(*args):
            leaves, tree = jax.tree_util.tree_flatten(args)
            key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
            if key not in cache:
                cache[key] = jitted.lower(*args).compile(JAX_COMPILE)
            return cache[key](*args)
        return call

    jax.jit = jit
    try:
        yield
    finally:
        jax.jit = real


def cfgs(depth, res=RES, spp=SPP):
    jcfg = jbdpt.BDPTConfig(width=res, height=res, spp=spp, max_depth=depth,
                            sampler=jsmp.SamplerConfig(kind="random", spp=spp))
    return jcfg, bridge.bdpt_config(jcfg)


def check_bdpt(jscene, tscene, jcam, tcam, depth, jax_strategies=True):
    """The port's image and strategy sums against the reference's; with
    jax_strategies False the reference renders its image alone."""
    jcfg, tcfg = cfgs(depth)
    with reference_jit():
        out_j = jbdpt.render(jscene, jcam, jcfg, debug_strategies=jax_strategies)
    img_j, strat_j = out_j if jax_strategies else (out_j, None)
    img_t, strat_t, stats = tbdpt.render(tscene, tcam, tcfg, debug_strategies=True,
                                         return_stats=True)
    img_j, img_t = np.asarray(img_j), img_t.numpy()
    assert np.isfinite(img_t).all() and img_t.mean() > 0.05
    np.testing.assert_allclose(img_t, img_j, rtol=RTOL, atol=ATOL)
    _check(img_t, img_j)
    if strat_j is not None:
        assert sorted(strat_t, key=str) == sorted(strat_j, key=str)
        for k, (wj, uj) in strat_j.items():
            wt, ut = strat_t[k]
            np.testing.assert_allclose([wt, ut], [wj, uj], rtol=RTOL, atol=1e-7,
                                       err_msg=str(k))
    # the weighted strategies add up to the image
    total = sum(w for w, _ in strat_t.values())
    np.testing.assert_allclose(total, img_t.mean(), rtol=1e-4)
    assert float(stats["rays_traced"]) >= RES * RES * SPP
    return strat_t


def test_bdpt_area_light_matches_jax():
    strat = check_bdpt(jcornell_spheres(light="area"),
                       tscenes.cornell_spheres(False, "area", "cpu", tile=256),
                       jcornell_camera((RES, RES)), tscenes.cornell_camera((RES, RES), "cpu"),
                       3)
    # the emitter hit, light sampling, a connection and a splat all carry light
    assert all(strat[k][0] > 0 for k in ((0, 2), (1, 2), (2, 2), (2, 3), (2, 1), (4, 1)))


def test_config_converters_keep_every_field():
    from pbrt_tpu.integrate import mlt as jmlt, sppm as jsppm
    for jc, conv in ((jbdpt.BDPTConfig(spp=3), bridge.bdpt_config),
                     (jsppm.SPPMConfig(gather="grid", alpha=0.5), bridge.sppm_config),
                     (jmlt.MLTConfig(n_chains=7), bridge.mlt_config)):
        tc = conv(jc)
        assert tc._fields == jc._fields
        assert tc._replace(sampler=None)._asdict() == jc._replace(sampler=None)._asdict()
        assert tuple(tc.sampler) == tuple(jc.sampler)
        assert tuple(conv(type(jc)())) == tuple(type(tc)())      # the same defaults
    with pytest.raises(ValueError):
        bridge.bdpt_config(jsppm.SPPMConfig())
