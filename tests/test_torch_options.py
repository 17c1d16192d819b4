"""Direct lighting on the Cornell box under each sampler kind but zerotwo
and random (which tests/test_torch_cornell.py's renders draw), 16×16 at
8 spp, and the path tracer at depth 1, 32×32, 2 spp under the power and
spatial light strategies with the area light and a point light (the
spatial grid 4³ voxels of 2 points, carried through the bridge; depth 1
runs both strategies' selection and their pmf in the emission MIS): the
port on the CPU against the JAX package, the pixel check of
tests/test_oracle.py. The direct renders run op by op in the JAX
package (they share their 2,048-lane shapes, so each op compiles once
for the file, sooner than compiling each render whole), but stratified,
whose cycle walk is a while_loop that op by op compiles anew each call;
the path renders compile whole, sooner here than op by op."""
import numpy as np
import pytest

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.integrate import driver as jdriver, path as jpath
from pbrt_tpu.lights import distrib as jdistrib, lights as jlights
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_oracle import _check
from tests.test_torch_core import _camera_dict
from tests.test_torch_cornell import RES, SPP, render_pair
from tests.test_torch_lights import tri_lights, with_lights
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.integrate import driver as tdriver, path as tpath


@pytest.mark.parametrize("kind", ["stratified", "maxmin", "halton", "sobol"])
def test_sampler_kind_through_direct_lighting(kind):
    _check(*render_pair("direct", False, "area", kind=kind, res=16, spp=8,
                        jit=kind == "stratified"))   # the others share one op cache


@pytest.mark.parametrize("strategy", ["power", "spatial"])
def test_path_under_light_strategy(strategy):
    js = jcornell_spheres(light="area")
    js = with_lights(js, [dict(kind=jlights.LIGHT_AREA_TRI, tri_ids=list(tri_lights(js)),
                               L=(12.0, 12.0, 12.0)),
                          dict(kind=jlights.LIGHT_POINT, p=(0.2, 0.6, -0.3), I=(0.8, 0.6, 0.4))])
    if strategy == "spatial":
        js = js._replace(light_distrib=jdistrib.build_spatial(js, js.lights, (4, 4, 4), 2))
    ts = bridge.scene_from_numpy(scene_tree(js), "cpu", tile=256)
    jcfg, tcfg = [m.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=1,
                                 light_strategy=strategy,
                                 sampler=s.SamplerConfig(kind="zerotwo", spp=SPP))
                  for m, s in ((jdriver, jsmp), (tdriver, tsmp))]
    jc = jcornell_camera((RES, RES))
    img_j = np.asarray(jdriver.render(js, jc, jcfg, jpath.make_li(jcfg)))
    img_t = tdriver.render(ts, bridge.camera_from_numpy(_camera_dict(jc), "cpu"), tcfg,
                           tpath.make_li(tcfg)).numpy()
    assert img_t.mean() > 0.1
    _check(img_t, img_j)
