"""The port's sensor against pbrt_tpu, per lane: every filter kind's
evaluate and sample_offset, every camera kind's generate_rays_weighted and
cone_start, and the realistic camera's focus, exit pupil and rays.

Inputs are numpy draws from fixed seeds; torch runs on one thread.
Tolerances:
- filters: evaluate at atol 1e-6 (exp and sin differ by an ulp between
  XLA and PyTorch: 1.2e-7 seen), offsets at atol 1e-6 (sqrt, log, cos and
  sin by an ulp: 1.2e-7 seen), weights at rtol 1e-6; the |f| tables of
  mitchell and lanczos equal bit for bit;
- camera rays at atol 1e-6 as in tests/test_torch_core.py, through the
  JAX camera carried across by the bridge and through the port's own
  (its matrices built in float64); the realistic camera's rays pass
  eleven surfaces, 4.2e-7 seen; the weights (the stack's vignetting)
  equal; cone_start at rtol 1e-6;
- the realistic camera: the focused stack's z and the exit-pupil bounds
  equal bit for bit (both packages trace the same numpy.random points in
  float32; a point that a last-bit difference puts across an aperture's
  edge would show here as a moved bound)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.cameras import cameras as jcam, realistic as jreal
from pbrt_tpu.core import transform as jtf
from pbrt_tpu.film import filters as jfilt
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.cameras import cameras as tcam, realistic as treal
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.core import transform as ttf
from pbrt_tpu_torch.film import filters as tfilt
from pbrt_tpu_torch.integrate import driver as tdriver

N = 4096
FILTERS = {"box": {}, "triangle": dict(radius=2.0), "gaussian": dict(radius=1.5),
           "mitchell": dict(radius=2.0), "lanczos": dict(radius=4.0)}


def camera_dict(cam):
    """A JAX camera's fields as numpy, as bridge.camera_from_numpy takes them."""
    d = {"kind": type(cam).__name__}
    for k in cam._fields:
        v = getattr(cam, k)
        d[k] = ((np.asarray(v.m), np.asarray(v.m_inv)) if isinstance(v, jtf.Transform)
                else v if k == "resolution" else np.asarray(v))
    return d


@pytest.mark.parametrize("kind", list(FILTERS))
def test_filter_evaluate_and_sample_offset(kind):
    fj, ft = jfilt.Filter(kind=kind, **FILTERS[kind]), tfilt.Filter(kind=kind, **FILTERS[kind])
    r = np.random.RandomState(3)
    u = r.rand(N, 2).astype(np.float32)
    xy = ((r.rand(N, 2) * 2 - 1) * 1.1 * ft.radius).astype(np.float32)
    ej = np.asarray(jfilt.evaluate(fj, jnp.asarray(xy[:, 0]), jnp.asarray(xy[:, 1])))
    et = tfilt.evaluate(ft, torch.as_tensor(xy[:, 0]), torch.as_tensor(xy[:, 1])).numpy()
    np.testing.assert_allclose(et, ej, rtol=0, atol=1e-6)
    assert (ej != 0).mean() > 0.5
    oj, wj = (np.asarray(a) for a in jfilt.sample_offset(fj, jnp.asarray(u)))
    ot, wt = (a.numpy() for a in tfilt.sample_offset(ft, torch.as_tensor(u)))
    np.testing.assert_allclose(ot, oj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(wt, wj, rtol=1e-6, atol=0)
    assert (np.abs(ot) <= ft.radius).all()
    if kind in ("mitchell", "lanczos"):
        assert (wt < 0).any() and (wt > 0).any()      # the negative lobes
        xs_j, cdf_j, integ_j = jfilt._abs_cdf_table(fj)
        xs_t, cdf_t, integ_t = tfilt._abs_cdf_table(ft)
        assert np.array_equal(xs_t, np.asarray(xs_j)) and np.array_equal(cdf_t, np.asarray(cdf_j))
        assert integ_t == integ_j


def test_unknown_filter_is_refused():
    with pytest.raises(ValueError, match="sinc"):
        tfilt.sample_offset(tfilt.Filter(kind="sinc"), torch.zeros(4, 2))


POS, LOOK, UP = [0.5, 0.5, 1.35], [0.5, 0.35, -0.5], [0.0, 1.0, 0.0]
RES = (24, 32)


@functools.lru_cache(maxsize=None)
def cameras(kind):
    """(JAX camera, the port's own) of one kind at RES (made once: the JAX
    realistic camera's focus and pupil take seconds op by op)."""
    jc2w = jtf.look_at(np.array(POS), np.array(LOOK), np.array(UP))
    tc2w = ttf.look_at_np(POS, LOOK, UP)
    lens = dict(lens_radius=0.05, focal_distance=1.6)
    if kind == "thin_lens":
        return (jcam.make_perspective(jc2w, 42.0, RES, **lens),
                tcam.make_perspective(tc2w, 42.0, RES, "cpu", **lens))
    if kind == "orthographic":
        return jcam.make_orthographic(jc2w, RES), tcam.make_orthographic(tc2w, RES, "cpu")
    if kind == "orthographic_lens":
        return (jcam.make_orthographic(jc2w, RES, **lens),
                tcam.make_orthographic(tc2w, RES, "cpu", **lens))
    if kind == "environment":
        return jcam.make_environment(jc2w, RES), tcam.make_environment(tc2w, RES, "cpu")
    return (jreal.make_realistic(jc2w, jreal.DEMO_LENS, RES, focus_distance=1.6),
            treal.make_realistic(tc2w, treal.DEMO_LENS, RES, "cpu", focus_distance=1.6))


@pytest.mark.parametrize("kind", ["thin_lens", "orthographic", "orthographic_lens",
                                  "environment", "realistic"])
def test_camera_rays_and_cone(kind):
    jc, tc = cameras(kind)
    r = np.random.RandomState(1)
    pf = (r.rand(N, 2) * [RES[1], RES[0]]).astype(np.float32)
    ul, ut = r.rand(N, 2).astype(np.float32), r.rand(N).astype(np.float32)
    gen = jax.jit(lambda *a: jcam.generate_rays_weighted(jc, *a))
    oj, dj, tj, wj = (np.asarray(a) for a in gen(jnp.asarray(pf), jnp.asarray(ul),
                                                 jnp.asarray(ut)))
    for cam in (bridge.camera_from_numpy(camera_dict(jc), "cpu"), tc):
        ot, dt, tt, wt = (a.numpy() for a in tcam.generate_rays_weighted(
            cam, torch.as_tensor(pf), torch.as_tensor(ul), torch.as_tensor(ut)))
        np.testing.assert_array_equal(wt, wj)
        live = wj > 0
        np.testing.assert_allclose(ot[live], oj[live], rtol=0, atol=1e-6)
        np.testing.assert_allclose(dt[live], dj[live], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(tcam.cone_start(cam), [float(x) for x in jcam.cone_start(jc)],
                                   rtol=1e-6)
        o3, d3, t3 = tcam.generate_rays(cam, torch.as_tensor(pf), torch.as_tensor(ul),
                                        torch.as_tensor(ut))
        assert np.array_equal(d3.numpy(), dt) and np.array_equal(o3.numpy(), ot)
    if kind == "realistic":
        assert 0.2 < wj.mean() < 0.9      # the stack vignettes the film's corners


def test_realistic_focus_and_exit_pupil():
    jc, tc = cameras("realistic")
    assert tc.z_front == tuple(float(z) for z in np.asarray(jc.z_front))
    np.testing.assert_array_equal(tc.exit_pupil.numpy(), np.asarray(jc.exit_pupil))
    # from the JAX package's focused stack, the port's pupil is the same
    bridged = bridge.camera_from_numpy(camera_dict(jc), "cpu")
    np.testing.assert_array_equal(treal.exit_pupil_np(bridged), np.asarray(jc.exit_pupil))
    # refocused at 0.5: the stack moves away from the film
    near = treal.make_realistic(ttf.look_at_np(POS, LOOK, UP), treal.DEMO_LENS, RES, "cpu",
                                focus_distance=0.5)
    assert near.z_front[-1] < tc.z_front[-1]


def test_vignetted_rays_keep_their_filter_weight():
    """A realistic camera's stopped ray adds zero radiance and its full
    filter weight to the film."""
    _, tc = cameras("realistic")
    cfg = tdriver.RenderConfig(width=RES[1], height=RES[0], spp=2,
                               filter=tfilt.Filter("mitchell", radius=2.0),
                               sampler=tsmp.SamplerConfig(kind="zerotwo", spp=2))
    pid, sid = tdriver.lane_ids(cfg, 0, 2, "cpu")
    out, wt = tdriver.render_lanes(None, tc, cfg, lambda s, o, d, p, i: torch.ones_like(o),
                                   pid, sid)
    _, _, cw, fw = tdriver.camera_rays(tc, cfg, pid, sid)
    assert 0 < float((cw == 0).float().mean()) < 1
    assert torch.equal(out[..., 0], cw) and torch.equal(wt, fw)
    assert (fw < 0).any()                 # mitchell's negative lobes reach the film


@pytest.mark.parametrize("kind", ["orthographic", "environment", "realistic"])
def test_importance_needs_a_perspective_camera(kind):
    _, tc = cameras(kind)
    p = torch.zeros(4, 3)
    for call in (lambda: tcam.camera_we(tc, p, p), lambda: tcam.camera_pdf_we(tc, p, p),
                 lambda: tcam.camera_sample_wi(tc, p, torch.zeros(4, 2))):
        with pytest.raises(ValueError, match=type(tc).__name__):
            call()
