"""The port's fit loop: tests/test_grad.py's recovery fit on the port
alone, and three steps of make_fit_step against pbrt_tpu's, torch.optim.Adam
against optax.adam (2e-2, the same betas and eps).

The recovery fit: the red wall's albedo perturbed to (0.1, 0.6, 0.6) and
recovered by 40 Adam steps on the L2 loss of a 24×24, 2-spp direct
render; the reference's thresholds (final loss under 0.2× the first,
albedo error under 0.35×).

The three steps: kd and emit of the Cornell box from a perturbed start,
the default relative-L2 loss (its denominator detached, stop_gradient in
JAX), the clamp after each step; 8×8, 1 spp, direct, random sampler. After
each step the params agree at rtol 1e-5, atol 1e-6: Adam's first steps
move each entry by about lr·sign(g), so this holds the optimiser state
and the clamp, and the gradients' sign and scale, to the reference."""
import dataclasses

import numpy as np
import jax
import torch

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.diff import inverse as jinv
from pbrt_tpu.integrate import direct as jdirect, driver as jdriver
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_torch_media import one_torch_thread  # noqa: F401

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.diff import inverse as tinv
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver


def _render(size, spp):
    cam = tscenes.cornell_camera((size, size), "cpu")
    cfg = tdriver.RenderConfig(width=size, height=size, spp=spp, max_depth=3,
                               sampler=tsmp.SamplerConfig(kind="random", spp=spp))
    li = tdirect.make_li(cfg)
    return lambda scene, step: tdriver.render(scene, cam, cfg, li)


def test_inverse_rendering_recovers_albedo():
    scene = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    render_fn = _render(24, 2)
    target = render_fn(scene, 0).detach()
    wrong_kd = scene.materials.kd.clone()
    wrong_kd[1] = torch.tensor([0.1, 0.6, 0.6])
    bad = dataclasses.replace(scene, materials=dataclasses.replace(scene.materials,
                                                                   kd=wrong_kd))
    fitted, losses = tinv.fit(bad, target, render_fn, n_steps=40,
                              param_get=lambda s: {"materials": {"kd": s.materials.kd}},
                              loss_fn=tinv.l2_loss)
    err0 = float(torch.abs(wrong_kd[1] - scene.materials.kd[1]).mean())
    err1 = float(torch.abs(fitted.materials.kd[1] - scene.materials.kd[1]).mean())
    assert losses[-1] < losses[0] * 0.2, (losses[0], losses[-1])
    assert err1 < err0 * 0.35, (err0, err1)


def _perturb(kd, emit):
    return {"materials": {"kd": kd * 0.7 + 0.1}, "lights": {"emit": emit * 0.6}}


def test_adam_steps_match_optax():
    size, spp = 8, 1
    jscene = jcornell_spheres()
    jcfg = jdriver.RenderConfig(width=size, height=size, spp=spp, max_depth=3,
                                sampler=jsmp.SamplerConfig(kind="random", spp=spp))
    jli = jdirect.make_li(jcfg)
    jcam = jcornell_camera((size, size))

    def jrender(sc, step):
        return jdriver.render(sc, jcam, jcfg, jli, jit=False)

    def jget(sc):
        return {"materials": {"kd": sc.materials.kd}, "lights": {"emit": sc.lights.emit}}

    jtarget = jrender(jscene, 0)
    jstart = jinv.apply_params(jscene, _perturb(jscene.materials.kd, jscene.lights.emit))
    init_j, step_j = jinv.make_fit_step(jrender, param_get=jget)
    state_j = init_j(jstart)

    tscene = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    trender = _render(size, spp)
    ttarget = trender(tscene, 0).detach()
    tstart = tinv.apply_params(tscene, bridge.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jget(jstart)), "cpu"))
    init_t, step_t = tinv.make_fit_step(trender, param_get=jget)
    state_t = init_t(tstart)
    for _ in range(3):
        state_j, loss_j = step_j(state_j, jstart, jtarget)
        state_t, loss_t = step_t(state_t, tstart, ttarget)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
        pj = jax.tree_util.tree_map(np.asarray, state_j.params)
        pt = bridge.params_to_numpy(state_t.params)
        for group, field in (("materials", "kd"), ("lights", "emit")):
            np.testing.assert_allclose(pt[group][field], pj[group][field], rtol=1e-5,
                                       atol=1e-6, err_msg=field)
    assert state_t.step == 3 and int(state_j.step) == 3
    moved = np.abs(pt["materials"]["kd"] - np.asarray(jstart.materials.kd))
    assert moved.max() > 0.05       # three steps of about 2e-2 each
