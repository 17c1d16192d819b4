"""The PyTorch port's light emission, camera importance, film splats and
spectrum tools against pbrt_tpu, per lane, on inputs made with numpy from
a seed.

- lights.sample_le for all eight light kinds (the Cornell box with
  pbrt_tpu_torch.scenes.all_kinds_rows, as tests/test_torch_lights.py),
  rtol 1e-5, atol 1e-6, the reference op by op (jitted, XLA rounds one
  cancelling direction component 4.7e-6 apart);
- cameras.camera_we, camera_pdf_we and camera_sample_wi of the Cornell
  camera (the JAX camera carried across by bridge.camera_from_numpy),
  rtol 1e-5, atol 1e-6 (raster positions atol 1e-4), valid masks equal;
- film.add_splats (positions inside and outside the film, many on one
  pixel, a mask) and film.resolve with a splat scale against the
  reference's develop, rtol 1e-6, atol 1e-6:
  the scatter adds in another order than XLA's;
- the spectrum tools: the CIE curves, wavelengths and RGB basis equal
  (the same numpy), the XYZ matrices, gamma, Planck's law and the
  rgb → spectrum → XYZ → rgb round trip of tests/test_maxmin_spectral.py
  at rtol 1e-5 (atol 1e-6), the round trip within 0.02 of its input."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.cameras import cameras as jcam
from pbrt_tpu.core import spectrum as jspec
from pbrt_tpu.film import film as jfilm
from pbrt_tpu.lights import lights as jlights
from scenes.cornell import cornell_camera as jcornell_camera
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_torch_core import _camera_dict
from tests.test_torch_lights import tri_lights, with_lights
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.cameras import cameras as tcam
from pbrt_tpu_torch.core import spectrum as tspec
from pbrt_tpu_torch.film import film as tfilm
from pbrt_tpu_torch.lights import lights as tlights
from pbrt_tpu_torch.scenes import all_kinds_rows

RTOL, ATOL = 1e-5, 1e-6
N = 8192


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **{"rtol": RTOL, "atol": ATOL, **kw})


def test_sample_le_every_kind():
    js = jcornell_spheres(light="area")
    js = with_lights(js, all_kinds_rows(tri_lights(js)))
    ts = bridge.scene_from_numpy(scene_tree(js), "cpu")
    assert ts.lights.kinds_present == tuple(range(8))
    r = np.random.RandomState(3)
    lt = r.randint(0, 8, N)
    u_pos, u_dir = r.rand(N, 2).astype(np.float32), r.rand(N, 2).astype(np.float32)
    jle = jlights.sample_le(js.lights, js, jnp.asarray(lt), jnp.asarray(u_pos),
                            jnp.asarray(u_dir), js.world_radius)
    tle = tlights.sample_le(ts.lights, ts, torch.as_tensor(lt), torch.as_tensor(u_pos),
                            torch.as_tensor(u_dir), ts.world_radius)
    for k in ("o", "d", "ng_l", "le", "pdf_pos", "pdf_dir"):
        _close(tle[k], jle[k], err_msg=k)
    lum = tle["le"].sum(-1).numpy()
    for k in range(8):       # every kind emits on some lanes, with a density
        assert (lum[lt == k] > 0).mean() > 0.2, k
        assert (tle["pdf_dir"].numpy()[lt == k] > 0).all(), k
    np.testing.assert_allclose(np.linalg.norm(tle["d"].numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.fixture(scope="module")
def cameras():
    jc = jcornell_camera((24, 32))
    return jc, bridge.camera_from_numpy(_camera_dict(jc), "cpu")


def test_camera_importance(cameras):
    jc, tc = cameras
    r = np.random.RandomState(4)
    o = np.broadcast_to(np.asarray(jc.camera_to_world.m)[:3, 3], (N, 3)).astype(np.float32)
    d = (np.array([0.0, 0.0, -1.0]) + r.uniform(-0.6, 0.6, (N, 3))).astype(np.float32)
    d[:64, 2] = 1.0                       # some face away from the film
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    J, T = jnp.asarray, torch.as_tensor
    we_j, pr_j, v_j = jcam.camera_we(jc, J(o), J(d))
    we_t, pr_t, v_t = tcam.camera_we(tc, T(o), T(d))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0.3 < v_t.float().mean() < 0.95
    _close(we_t, we_j)
    _close(pr_t, pr_j, atol=1e-4)
    for t, j in zip(tcam.camera_pdf_we(tc, T(o), T(d)), jcam.camera_pdf_we(jc, J(o), J(d))):
        _close(t, j)
    p_ref = (r.rand(N, 3) * np.array([1.0, 1.0, -1.0])).astype(np.float32)
    u = r.rand(N, 2).astype(np.float32)
    out_t = tcam.camera_sample_wi(tc, T(p_ref), T(u))
    out_j = jcam.camera_sample_wi(jc, J(p_ref), J(u))
    for k, t, j in zip(("wi", "we", "pdf", "p_raster", "p_lens"), out_t, out_j):
        _close(t, j, err_msg=k, **({"atol": 1e-4} if k == "p_raster" else {}))
    assert (out_t[1] > 0).float().mean() > 0.5


def test_add_splats_and_develop():
    h, w = 12, 16
    r = np.random.RandomState(5)
    pfilm = (r.rand(N, 2) * np.array([w + 4, h + 4]) - 2).astype(np.float32)
    pfilm[:1024] = (3.5, 7.25)            # many splats on one pixel
    value = r.rand(N, 3).astype(np.float32)
    enabled = r.rand(N) < 0.8
    film_j = jfilm.new_film(h, w)
    film_j = film_j._replace(pixels=jnp.asarray(r.rand(h, w, 3).astype(np.float32)),
                             weights=jnp.asarray(r.rand(h, w).astype(np.float32) + 0.5))
    film_j = jfilm.add_splats(film_j, jnp.asarray(pfilm), jnp.asarray(value),
                              jnp.asarray(enabled))
    splats = tfilm.add_splats(torch.zeros((h, w, 3)), torch.as_tensor(pfilm),
                              torch.as_tensor(value), torch.as_tensor(enabled))
    _close(splats, film_j.splats, rtol=1e-6)
    img_t = tfilm.resolve(torch.as_tensor(np.asarray(film_j.pixels)),
                          torch.as_tensor(np.asarray(film_j.weights)), splats, 0.25)
    _close(img_t, jfilm.develop(film_j, splat_scale=0.25), rtol=1e-6)
    assert float(splats[7, 3].sum()) > 100.0


def test_spectrum_tools():
    for n in (12, 60):
        np.testing.assert_array_equal(tspec.spectral_lambdas(n), jspec.spectral_lambdas(n))
        np.testing.assert_array_equal(tspec.cie_xyz_curves(tspec.spectral_lambdas(n)),
                                      jspec.cie_xyz_curves(jspec.spectral_lambdas(n)))
        np.testing.assert_array_equal(tspec.rgb_reflectance_basis(n),
                                      np.asarray(jspec.rgb_reflectance_basis(n)))
    r = np.random.RandomState(6)
    c = r.rand(256, 3).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    for name in ("rgb_to_xyz", "xyz_to_rgb", "gamma_correct", "inverse_gamma_correct",
                 "luminance"):
        _close(getattr(tspec, name)(T(c)), getattr(jspec, name)(J(c)), err_msg=name)
    lams = tspec.spectral_lambdas(60).astype(np.float32)
    for temp in (2700.0, 6500.0):
        _close(tspec.blackbody(T(lams), temp), jspec.blackbody(J(lams), temp), atol=0)
        _close(tspec.blackbody_normalized(T(lams), temp),
               jspec.blackbody_normalized(J(lams), temp))
    # the round trip of tests/test_maxmin_spectral.py
    cols = np.array([[1.0, 1.0, 1.0], [0.2, 0.5, 0.8], [0.7, 0.3, 0.1], [0.0, 0.0, 0.0],
                     [0.5, 0.5, 0.0]], np.float32)
    for n in (12, 60):
        s_t = tspec.rgb_to_spectrum(T(cols), n)
        _close(s_t, jspec.rgb_to_spectrum(J(cols), n))
        back_t = tspec.xyz_to_rgb(tspec.sampled_to_xyz(s_t))
        _close(back_t, jspec.xyz_to_rgb(jspec.sampled_to_xyz(J(s_t.numpy()))))
        np.testing.assert_allclose(back_t.numpy(), cols, atol=0.02, rtol=0.02)
