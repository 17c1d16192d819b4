"""The port's gradients (torch.autograd, path replay) against jax.grad of
pbrt_tpu, and the finite-difference checks of tests/test_grad.py on the
port alone.

Gradients: of the mean of a 16×16 render, 2 spp, depth 3, random
sampler, with respect to every leaf of default_params (kd, ks, kr, kt,
roughness, eta, emit), on the Cornell box through direct and path, and on
its specular variant (mirror and glass spheres) through direct; the
specular path is tests/test_torch_grad_specular.py. The port renders its
native scene (one cluster through the plain versions of the kernels),
JAX its brute-force scene on the same sample streams. Tolerance: rtol
1e-4, atol 1e-6 on kd, ks, kr, kt and emit (the largest difference seen
is 3.3e-6 relative), rtol 1e-5 on the loss.

eta and roughness are not held to the reference: its gradients of them
are NaN on the specular box (every entry). A NaN in the branch a `where`
does not select still reaches the gradient, and the glass Fresnel term is
evaluated on every lane. The port keeps that arithmetic and masks nothing,
but it detaches the rays it hands the tracers, so the NaN that reaches the
reference through the hit point does not reach it: the port's roughness
gradient is finite (zero), and its eta gradient is NaN in the row of the
white walls (their lanes run the glass branch under total internal
reflection) and finite in the others. The test states both sides. On the
matte box every leaf, eta and roughness included, is zero on both sides.

The JAX reference is compiled once per case: jax.jit of value_and_grad,
with fewer LLVM passes (the same function; the compile takes about a
third less time, the gradients agree with the default build's to 1e-7).
Torch runs on one thread."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.diff import inverse as jinv
from pbrt_tpu.integrate import direct as jdirect, driver as jdriver, path as jpath
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_torch_media import one_torch_thread  # noqa: F401

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.diff import inverse as tinv
from pbrt_tpu_torch.diff.checkpoint import tree_flatten
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver, path as tpath

RES, SPP, DEPTH = 16, 2, 3
RTOL, ATOL = 1e-4, 1e-6
HELD = ("kd", "ks", "kr", "kt")
# fewer LLVM passes: the same function, a shorter compile
JAX_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def jax_value_and_grad(specular, integrator, depth=DEPTH):
    """(loss, grads) of the mean of the JAX render by jax.grad."""
    scene = jcornell_spheres(specular=specular)
    cfg = jdriver.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=depth,
                               sampler=jsmp.SamplerConfig(kind="random", spp=SPP))
    li = (jdirect if integrator == "direct" else jpath).make_li(cfg)
    cam = jcornell_camera((RES, RES))

    def loss(p):
        return jnp.mean(jdriver.render(jinv.apply_params(scene, p), cam, cfg, li, jit=False))

    params = jinv.default_params(scene)
    fn = jax.jit(jax.value_and_grad(loss)).lower(params).compile(JAX_COMPILE)
    value, grads = fn(params)
    return float(value), jax.tree_util.tree_map(np.asarray, grads)


def port_value_and_grad(specular, integrator, depth=DEPTH):
    """(loss, grads) of the mean of the port's render by torch.autograd."""
    scene = tscenes.cornell_spheres(specular, "area", "cpu", tile=256)
    cfg = tdriver.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=depth,
                               sampler=tsmp.SamplerConfig(kind="random", spp=SPP))
    li = (tdirect if integrator == "direct" else tpath).make_li(cfg)
    params = tinv.leaf_params(tinv.default_params(scene))
    leaves, unflatten = tree_flatten(params)
    loss = torch.mean(tdriver.render(tinv.apply_params(scene, params),
                                     tscenes.cornell_camera((RES, RES), "cpu"), cfg, li))
    grads = unflatten([g.numpy() for g in tinv.grads_of(loss, leaves)])
    return float(loss.detach()), grads


def check_against_jax(specular, integrator, depth=DEPTH):
    loss_j, gj = jax_value_and_grad(specular, integrator, depth)
    loss_t, gt = port_value_and_grad(specular, integrator, depth)
    np.testing.assert_allclose(loss_t, loss_j, rtol=1e-5)
    for k in HELD:
        np.testing.assert_allclose(gt["materials"][k], gj["materials"][k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    np.testing.assert_allclose(gt["lights"]["emit"], gj["lights"]["emit"], rtol=RTOL,
                               atol=ATOL)
    assert np.abs(gt["materials"]["kd"]).max() > 1e-3 and (gt["lights"]["emit"] > 0).all()
    eta_t, eta_j = gt["materials"]["eta"], gj["materials"]["eta"]
    rough_t, rough_j = gt["materials"]["roughness"], gj["materials"]["roughness"]
    if specular:
        # the reference: NaN in every entry; the port: see the module docstring
        assert np.isnan(eta_j).all() and np.isnan(rough_j).all()
        assert np.isnan(eta_t).tolist() == [True] + [False] * (len(eta_t) - 1)
        assert np.isfinite(rough_t).all() and not rough_t.any()
    else:
        for t, j in ((eta_t, eta_j), (rough_t, rough_j)):
            assert np.isfinite(j).all() and not j.any() and not t.any()
    return gt


@pytest.mark.parametrize("specular,integrator", [(False, "direct"), (False, "path"),
                                                 (True, "direct")])
def test_gradients_match_jax(specular, integrator):
    gt = check_against_jax(specular, integrator)
    if not specular:
        assert not gt["materials"]["kr"].any() and not gt["materials"]["kt"].any()


# ---- tests/test_grad.py's finite-difference checks, on the port alone

def _make_render(size=24, spp=2, integrator="direct"):
    cam = tscenes.cornell_camera((size, size), "cpu")
    cfg = tdriver.RenderConfig(width=size, height=size, spp=spp, max_depth=3,
                               sampler=tsmp.SamplerConfig(kind="random", spp=spp))
    li = tdirect.make_li(cfg) if integrator == "direct" else tpath.make_li(cfg)

    def render_fn(scene, step):
        return tdriver.render(scene, cam, cfg, li)

    return render_fn


def _scene():
    return tscenes.cornell_spheres(False, "area", "cpu", tile=256)


def test_grad_matches_fd_albedo():
    g, fd = tinv.finite_difference_check(_scene(), _make_render(),
                                         ("materials", "kd", (0, 0)), eps=1e-2)
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-3), (g, fd)
    assert abs(g) > 1e-4


def test_grad_matches_fd_emission():
    scene = _scene()
    kind = scene.lights.kind.numpy()
    lid = int(np.argwhere(kind == 3)[0, 0]) if (kind == 3).any() else 0
    g, fd = tinv.finite_difference_check(scene, _make_render(),
                                         ("lights", "emit", (lid, 1)), eps=1e-2)
    assert abs(g - fd) < 0.05 * max(abs(fd), 1e-3), (g, fd)
    assert g > 0


def test_grad_path_integrator_albedo():
    g, fd = tinv.finite_difference_check(_scene(), _make_render(integrator="path"),
                                         ("materials", "kd", (0, 1)), eps=1e-2)
    assert abs(g - fd) < 0.08 * max(abs(fd), 1e-3), (g, fd)
