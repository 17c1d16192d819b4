"""The PyTorch port's light table, light selection and the power and
spatial strategies vs the JAX package.

The table holds all eight kinds in the Cornell box
(pbrt_tpu_torch.scenes.all_kinds_rows): the ceiling quad and a sphere as area lights, a point,
a spot, a distant, an infinite light on the Cornell sky, a goniometric
and a projection light. Inputs are made with numpy from a seed. The
native build_lights equals the JAX one (its env Distribution2D at rtol
1e-6: the two packages' cumulative sums add in different orders);
sample_li, env_radiance, env_pdf_li, power and pdf_li_area_scene are
held at rtol 1e-4 with atol 1e-6, as test_torch_direct.py's lane test;
build_spatial's grid at rtol 1e-5; select_light's picks equal. Path
renders under the power and spatial strategies are in
tests/test_torch_cornell.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.integrate import common as jcommon
from pbrt_tpu.lights import distrib as jdistrib, lights as jlights
from scenes.cornell import cornell_spheres as jcornell_spheres
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.integrate import common as tcommon
from pbrt_tpu_torch.lights import distrib as tdistrib, lights as tlights
from pbrt_tpu_torch.scenes import all_kinds_rows, cornell_sky, gonio_image

RTOL, ATOL = 1e-4, 1e-6


def with_lights(js, rows):
    table = jlights.build_lights(rows, tri=js.tri, quad=js.quad, env_image=cornell_sky(),
                                 gonio_image=gonio_image())
    return js._replace(lights=table)


def tri_lights(js):
    return np.nonzero(np.asarray(js.tri.light_id) >= 0)[0]


@pytest.fixture(scope="module")
def scenes():
    """The JAX scene with all eight kinds and its spatial grid (4³ voxels,
    2 points each), and the port's scene through the bridge."""
    js = jcornell_spheres(light="area")
    js = with_lights(js, all_kinds_rows(tri_lights(js)))
    js = js._replace(light_distrib=jdistrib.build_spatial(js, js.lights, (4, 4, 4), 2))
    return js, bridge.scene_from_numpy(scene_tree(js), "cpu")


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **{"rtol": RTOL, "atol": ATOL, **kw})


def test_build_lights_equals_the_jax_table(scenes):
    js, ts = scenes
    assert ts.lights.kinds_present == tuple(range(8)) == js.lights.kinds_present
    native = tlights.build_lights(
        all_kinds_rows(tri_lights(js)), np.asarray(js.tri.positions),
        np.asarray(js.tri.indices), np.asarray(js.quad.params), cornell_sky(),
        gonio_image=gonio_image(), device="cpu")
    for name, _ in tlights.COLUMNS:
        assert torch.equal(getattr(native, name), getattr(ts.lights, name)), name
    assert native.env_index == ts.lights.env_index == 5
    for part in ("conditional", "marginal"):
        for k in ("func", "cdf", "func_int"):
            _close(getattr(getattr(native.env_dist, part), k),
                   getattr(getattr(js.lights.env_dist, part), k), rtol=1e-6, atol=1e-7)


def _lanes(n, seed):
    r = np.random.RandomState(seed)
    box = np.array([1.0, 1.0, -1.0])
    return (r.randint(0, 8, n), (r.rand(n, 3) * box).astype(np.float32),
            r.rand(n, 2).astype(np.float32), (r.rand(n, 3) * box).astype(np.float32),
            r)


def test_sample_li_every_kind(scenes):
    js, ts = scenes
    lt, p_ref, u2, _, _ = _lanes(8192, 0)
    jls = jlights.sample_li(js.lights, js, jnp.asarray(lt), jnp.asarray(p_ref),
                            jnp.asarray(u2), js.world_radius)
    tls = tlights.sample_li(ts.lights, ts, torch.as_tensor(lt), torch.as_tensor(p_ref),
                            torch.as_tensor(u2), ts.world_radius)
    for k in ("wi", "li", "pdf", "p_light", "dist", "ng_l"):
        _close(tls[k], jls[k], err_msg=k)
    np.testing.assert_array_equal(tls["is_delta"].numpy(), np.asarray(jls["is_delta"]))
    lum = tls["li"].sum(-1).numpy()
    for k in (0, 1, 2, 3, 5, 6, 7):             # these kinds light some lanes
        assert (lum[lt == k] > 0).mean() > 0.2, k
    # the reference's sphere sample from outside lands on the far side,
    # facing away (ROADMAP Queue C), so the one-sided sphere light gives none
    assert (lum[lt == 4] == 0).all()


def test_env_radiance_pdf_and_power(scenes):
    js, ts = scenes
    r = np.random.RandomState(1)
    d = r.randn(8192, 3).astype(np.float32)
    J, T = jnp.asarray(d), torch.as_tensor(d)
    _close(tlights.env_radiance(ts.lights, T), jlights.env_radiance(js.lights, J))
    _close(tlights.env_pdf_li(ts.lights, T), jlights.env_pdf_li(js.lights, J))
    _close(tlights.power(ts.lights, ts.world_radius),
           jlights.power(js.lights, js.world_radius))


def test_pdf_li_area_scene(scenes):
    """For the area lights (triangles and the sphere, from outside and
    inside it) at random surface points and normals."""
    js, ts = scenes
    _, p_ref, _, p_hit, r = _lanes(8192, 2)
    lid = r.choice([3, 4], 8192)
    p_ref[:512] = np.asarray(js.quad.obj_to_world)[0, :3, 3] + r.uniform(-0.1, 0.1, (512, 3))
    ng = r.randn(8192, 3).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)
    T, J = torch.as_tensor, jnp.asarray
    _close(tlights.pdf_li_area_scene(ts.lights, ts, T(lid), T(p_ref), T(p_hit), T(ng)),
           jlights.pdf_li_area_scene(js.lights, js, J(lid), J(p_ref), J(p_hit), J(ng)))


def test_build_spatial(scenes):
    js, ts = scenes
    tsd = tdistrib.build_spatial(ts, ts.lights, resolution=(4, 4, 4), n_estimate=2)
    _close(tsd.grid_cdf, js.light_distrib.grid_cdf, rtol=1e-5)
    _close(tsd.grid_func, js.light_distrib.grid_func, rtol=1e-5)
    _close(tsd.world_min, js.light_distrib.world_min)


@pytest.mark.parametrize("strategy", ["uniform", "power", "spatial"])
def test_select_light(scenes, strategy):
    js, ts = scenes
    lt, p, _, _, r = _lanes(8192, 3)
    u = r.rand(8192).astype(np.float32)
    ji, jpmf = jcommon.select_light(js, strategy, jnp.asarray(p), jnp.asarray(u))
    ti, tpmf = tcommon.select_light(ts, strategy, torch.as_tensor(p), torch.as_tensor(u))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert len(np.unique(np.asarray(ji))) == 8
    _close(tpmf, jpmf)
    _close(tcommon.select_light_pmf(ts, strategy, torch.as_tensor(p), torch.as_tensor(lt)),
           jcommon.select_light_pmf(js, strategy, jnp.asarray(p), jnp.asarray(lt)))


def test_power_distribution_is_built_once_per_scene(scenes):
    """The power strategy's Distribution1D is built on first use and kept
    with the scene; a scene with another light table builds its own."""
    import dataclasses
    js, ts = scenes
    dist = ts.light_power
    assert ts.light_power is dist
    jd = jdistrib.power_distribution(js.lights, js.world_radius)
    _close(dist.func, jd.func)
    _close(dist.cdf, jd.cdf)
    two = dataclasses.replace(ts, lights=dataclasses.replace(
        ts.lights, emit=ts.lights.emit * torch.tensor([2.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0,
                                                       1.0])[:, None]))
    assert two.light_power is not dist
    _close(two.light_power.func, tlights.power(two.lights, two.world_radius))
