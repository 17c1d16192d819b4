"""The PyTorch port's quadrics vs the JAX package: the six kinds, whole
and partial (z and φ clipped, a disk with an inner radius, a
hyperboloid), through intersect_brute / occluded_brute and through the
scene queries with triangles in front of and behind them; sphere
sampling and its pdf from inside and outside the sphere.

Rays are made with numpy from a seed, aimed at each quadric's box. `hit`,
`occ` and the quadric index must be equal; t is held at rtol 1e-4, and
on the lanes both packages hit p and uv at rtol 1e-4 with atol 5e-5·t,
ng and dpdu at atol 5e-4·t. The atol grows with t because the two
packages' object-space rays differ by an ulp (XLA contracts the
transform with fused multiply-adds, PyTorch sums rounded products), and
the root of the quadric's equation moves that ulp by up to 2e-5 of the
distance on a grazing hit or near a cone's apex; arccos and atan2 differ
by an ulp too. Sphere sampling is held at rtol 1e-4, atol 1e-5."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.api import SceneBuilder
from pbrt_tpu.geom import quadrics as jquad, scene as jscene
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.geom import quadrics as tquad, scene as tscene

RTOL, ATOL = 1e-4, 1e-5


def _rot(axis, deg):
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m = np.eye(4, dtype=np.float32)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m


def _at(x, y, z, rot=None):
    m = np.eye(4, dtype=np.float32) if rot is None else rot.copy()
    m[:3, 3] = (x, y, z)
    return m


def quadric_scene(b):
    """Every kind, whole and partial, beside two triangles (a quad in
    front of part of the spheres and one behind the others), added to
    builder b: the JAX package's SceneBuilder or the port's own."""
    m = b.matte(kd=(0.5, 0.5, 0.5))
    b.add_sphere([-2.0, 0.0, 0.0], 0.6, m)
    b.add_sphere([-0.5, 0.0, 0.0], 0.5, m, z_min=-0.3, z_max=0.35, phi_max=1.5 * np.pi)
    b.add_disk(_at(1.0, 0.0, 0.0, _rot(0, 30)), 0.5, m, height=0.1, inner_radius=0.2,
               phi_max=1.7 * np.pi)
    b.add_cylinder(_at(2.5, 0.0, 0.0, _rot(1, 60)), 0.3, -0.4, 0.4, m, phi_max=1.6 * np.pi)
    b.add_cone(_at(-2.0, 2.0, 0.0, _rot(0, -70)), 0.5, 0.8, m)
    b.add_paraboloid(_at(-0.5, 2.0, 0.0, _rot(2, 20)), 0.4, 0.0, 0.6, m, phi_max=1.8 * np.pi)
    b.add_hyperboloid(_at(1.0, 2.0, 0.0, _rot(0, 45)), 4.0, 2.0, -0.4, 0.4, m)
    b.add_hyperboloid(_at(2.5, 2.0, 0.0), 6.0, 3.0, -0.3, 0.5, m, phi_max=1.2 * np.pi)
    b.add_quad([-3, -1, 1.5], [-1, -1, 1.5], [-1, 1, 1.5], [-3, 1, 1.5], m)
    b.add_quad([0, 1, -1.5], [3, 1, -1.5], [3, 3, -1.5], [0, 3, -1.5], m)
    return b


@pytest.fixture(scope="module")
def scenes():
    js = quadric_scene(SceneBuilder()).build()
    return js, bridge.scene_from_numpy(scene_tree(js), "cpu")


def _rays(js, n, seed):
    """Rays from random origins around the scene toward random points of
    random quadrics' boxes, a share of them from inside the boxes."""
    r = np.random.RandomState(seed)
    o2w = np.asarray(js.quad.obj_to_world)
    q = r.randint(0, o2w.shape[0], n)
    tgt = o2w[q, :3, 3] + r.uniform(-0.7, 0.7, (n, 3))
    o = np.asarray(js.world_center) + r.randn(n, 3) * 3.0
    inside = r.rand(n) < 0.15
    o[inside] = o2w[q[inside], :3, 3] + r.uniform(-0.2, 0.2, (inside.sum(), 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(r.rand(n) < 0.1, r.uniform(0.5, 3.0, n), np.inf).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), t_min, t_max


def _close(t, j, mask=None, atol=ATOL):
    t, j = t.numpy(), np.asarray(j)
    if mask is not None:
        t, j = t[mask], j[mask]
        if not np.isscalar(atol):
            atol = atol[mask]
    if not np.isscalar(atol) and j.ndim > atol.ndim:
        atol = atol[..., None]
    assert (np.abs(t - j) <= atol + RTOL * np.abs(j)).all(), np.abs(t - j).max()


def test_native_builder_equals_the_jax_builder(scenes):
    """The port's scene builder makes the JAX builder's quadric pool and
    world bounds, all six kinds present."""
    js, ts = scenes
    native = tscenes._Builder()
    native = quadric_scene(native).build("cpu", 256)
    assert native.quad.kinds_present == ts.quad.kinds_present == (0, 1, 2, 3, 4, 5)
    for f in ("kind", "obj_to_world", "world_to_obj", "params", "material_id", "light_id"):
        assert torch.equal(getattr(native.quad, f), getattr(ts.quad, f)), f
    assert torch.equal(native.world_center, ts.world_center)
    assert native.world_radius == ts.world_radius


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_and_occluded_brute(scenes, seed):
    js, ts = scenes
    o, d, t_min, t_max = _rays(js, 6000, seed)
    J = [jnp.asarray(a) for a in (o, d, t_min, t_max)]
    T = [torch.as_tensor(a) for a in (o, d, t_min, t_max)]
    jh, jt, ji, jp, jng, juv, jdp = jax.jit(jquad.intersect_brute)(js.quad, *J)
    th, tt, ti, tp, tng, tuv, tdp = tquad.intersect_brute(ts.quad, *T)
    hit = np.asarray(jh)
    np.testing.assert_array_equal(th.numpy(), hit)
    assert 0.2 < hit.mean() < 0.9
    # every kind is hit, and partial ones are missed through their cuts
    kinds = np.asarray(js.quad.kind)[np.asarray(ji)[hit]]
    assert set(kinds.tolist()) == {0, 1, 2, 3, 4, 5}
    np.testing.assert_array_equal(ti.numpy()[hit], np.asarray(ji)[hit])
    t = np.asarray(jt)
    _close(tt, jt, hit)
    for a, b, k in ((tp, jp, 5e-5), (tuv, juv, 5e-5), (tng, jng, 5e-4), (tdp, jdp, 5e-4)):
        _close(a, b, hit, k * t)
    np.testing.assert_array_equal(tquad.occluded_brute(ts.quad, *T).numpy(),
                                  np.asarray(jax.jit(jquad.occluded_brute)(js.quad, *J)))


def test_scene_queries_with_triangles(scenes):
    """intersect merges the quadric pass after the triangles (t_max =
    the triangle's t), intersect_occluded / occluded or the quadrics'
    any hit into the triangles'."""
    js, ts = scenes
    o, d, _, t_max = _rays(js, 4000, 2)
    jh = jscene.intersect(js, jnp.asarray(o), jnp.asarray(d))
    th = tscene.intersect(ts, torch.as_tensor(o), torch.as_tensor(d))
    valid = np.asarray(jh.valid)
    np.testing.assert_array_equal(th.valid.numpy(), valid)
    kind = np.asarray(jh.prim_kind)
    assert 0 < (kind[valid] == 0).sum() and 0 < (kind[valid] == 1).sum()
    for f in ("prim_kind", "prim_id", "material_id", "light_id"):
        np.testing.assert_array_equal(getattr(th, f).numpy(), np.asarray(getattr(jh, f)))
    t = np.where(valid, np.asarray(jh.t), 0.0)
    for f, k in (("t", 0.0), ("uv_scale", 0.0), ("p", 5e-5), ("uv", 5e-5), ("ng", 5e-4),
                 ("ns", 5e-4), ("dpdu", 5e-4)):
        _close(getattr(th, f), getattr(jh, f), valid, ATOL + k * t)
    tmax = np.where(np.isfinite(t_max), t_max, 2.5).astype(np.float32)
    j_occ = lambda o, d, t: jscene.occluded(js, o, d, t_max=t)  # noqa: E731
    occ_j = np.asarray(j_occ(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
    T = torch.as_tensor
    np.testing.assert_array_equal(tscene.occluded(ts, T(o), T(d), t_max=T(tmax)).numpy(),
                                  occ_j)
    h2, occ2 = tscene.intersect_occluded(ts, T(o), T(d), T(o[::-1].copy()),
                                         T(d[::-1].copy()), T(tmax[::-1].copy()))
    assert torch.equal(h2.valid, th.valid) and torch.equal(h2.prim_id, th.prim_id)
    occ_j2 = np.asarray(j_occ(jnp.asarray(o[::-1].copy()), jnp.asarray(d[::-1].copy()),
                              jnp.asarray(tmax[::-1].copy())))
    np.testing.assert_array_equal(occ2.numpy(), occ_j2)


@pytest.mark.parametrize("where", ["outside", "inside"])
def test_sphere_sample_and_pdf(scenes, where):
    js, ts = scenes
    r = np.random.RandomState(5)
    n = 4096
    qid = np.zeros(n, np.int64)          # the whole sphere at (-2, 0, 0), r = 0.6
    c = np.array([-2.0, 0.0, 0.0])
    dirs = r.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dist = r.uniform(0.8, 4.0, n) if where == "outside" else r.uniform(0.0, 0.5, n)
    p_ref = (c + dirs * dist[:, None]).astype(np.float32)
    u2 = r.rand(n, 2).astype(np.float32)
    J = (jnp.asarray(qid), jnp.asarray(p_ref), jnp.asarray(u2))
    T = (torch.as_tensor(qid), torch.as_tensor(p_ref), torch.as_tensor(u2))
    jp, jn, jpdf = jquad.sphere_sample(js.quad, *J)
    tp, tn, tpdf = tquad.sphere_sample(ts.quad, *T)
    for a, b in ((tp, jp), (tn, jn), (tpdf, jpdf)):
        _close(a, b)
    wi = (np.asarray(jp) - p_ref)
    wi = (wi / np.linalg.norm(wi, axis=-1, keepdims=True)).astype(np.float32)
    _close(tquad.sphere_pdf(ts.quad, T[0], T[1], torch.as_tensor(wi)),
           jquad.sphere_pdf(js.quad, J[0], J[1], jnp.asarray(wi)))
    assert (np.asarray(jpdf) > 0).all()
