"""The port's instances against pbrt_tpu on tests/test_instances.py's
scenes: one stored copy, a rotated and non-uniformly scaled instance,
slerp and the smear, the 100-instance field through the pre-cull, the
emissive instance, and a rotating, scaled, moving pair.

- Each scene built by both packages' SceneBuilder: every InstanceSet
  column, world_center and world_radius, and the light table bit for bit.
- intersect / occluded / intersect_occluded at per-lane shutter times:
  per lane valid, triangle, material and light ids equal, t, p and the
  normals at rtol 1e-5, atol 1e-6 on the brute-force route (the JAX
  package's); through the cluster tracer (the port's route under
  build(bvh=True)) within tests/test_torch_cluster.py's tolerances.
- The pair wavefront picks each lane's least (t, instance): an earlier
  instance wins a tie, as the JAX package's strict-< merge gives.
- A path render of the animated instance and a direct render of the
  emissive-instance box at 16×16 against pbrt_tpu: the pixel check.

Torch runs on one thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pbrt_tpu.api import SceneBuilder as JBuilder
from pbrt_tpu.cameras import make_perspective as jmake_perspective
from pbrt_tpu.core import samplers as jsmp, transform as jtf
from pbrt_tpu.geom import instances as jinst, scene as jscene
from pbrt_tpu.integrate import direct as jdirect, driver as jdriver, path as jpath
from tests.test_instances import _icosphere, _translate
from tests.test_oracle import _check
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sensor import camera_dict
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.api import SceneBuilder as TBuilder
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.geom import instances as tinst, scene as tscene
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver, path as tpath

RTOL, ATOL = 1e-5, 1e-6
TILE = 256


def _rot_y(deg):
    m = np.eye(4)
    c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def two_instances(b):
    verts, idx = _icosphere(0.5, 1)
    m_red, m_blue = b.matte(kd=(0.8, 0.1, 0.1)), b.matte(kd=(0.1, 0.1, 0.8))
    proto = b.instanced_prototype(verts, idx)
    b.add_instance(proto, m_red, _translate(-1.0, 0.0, 0.0))
    b.add_instance(proto, m_blue, _translate(+1.0, 0.0, 0.0))
    b.point_light((0.0, 3.0, 0.0), (30.0, 30.0, 30.0))


def rotated_scaled(b):
    m = b.matte(kd=(0.5, 0.5, 0.5))
    proto = b.instanced_prototype(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                                  np.array([[0, 1, 2]], np.int32))
    rx = np.eye(4)
    rx[:3, :3] = [[1, 0, 0], [0, 0, -1], [0, 1, 0]]
    b.add_instance(proto, m, rx @ np.diag([2.0, 1.0, 0.5, 1.0]))
    b.point_light((0.0, 3.0, 0.0), (10.0, 10.0, 10.0))


def animated(b, moving=True):
    verts, idx = _icosphere(0.4, 1)
    m = b.matte(kd=(0.05, 0.05, 0.05))
    proto = b.instanced_prototype(verts, idx)
    b.add_instance(proto, m, _translate(-0.8, 0.0, 0.0),
                   transform1=_translate(0.8, 0.0, 0.0) if moving else None)
    b.infinite_light(radiance=1.0)


def spinning(b):
    """Rotating and moving, non-uniformly scaled: the slerp at 70° and the
    static linear part; a static instance in the same (animated) set."""
    verts, idx = _icosphere(0.5, 1)
    m0, m1 = b.plastic(kd=(0.4, 0.2, 0.1), ks=(0.3,) * 3), b.matte(kd=(0.6, 0.6, 0.6))
    proto = b.instanced_prototype(verts, idx, normals=verts)
    s = np.diag([1.4, 0.6, 0.9, 1.0])
    b.add_instance(proto, m0, _translate(-0.6, 0.2, 0.0) @ _rot_y(20) @ s,
                   transform1=_translate(-0.3, 0.1, 0.2) @ _rot_y(90) @ s)
    b.add_instance(proto, m1, _translate(0.8, 0.0, 0.0) @ _rot_y(-35) @ s)
    b.point_light((0.0, 3.0, 1.0), (20.0, 20.0, 20.0))


def field(b):
    verts, idx = _icosphere(0.4, 1)
    m = b.matte(kd=(0.6, 0.6, 0.6))
    proto = b.instanced_prototype(verts, idx)
    r = np.random.RandomState(7)
    centers = np.stack([r.uniform(-20, 20, 100), r.uniform(-20, 20, 100),
                        r.uniform(-40, -5, 100)], axis=1)
    for c in centers:
        b.add_instance(proto, m, _translate(*c))
    b.point_light((0.0, 30.0, 0.0), (900.0, 900.0, 900.0))


QUAD_V = np.array([[-0.3, 0, -0.3], [0.3, 0, -0.3], [0.3, 0, 0.3], [-0.3, 0, 0.3]], np.float32)
QUAD_I = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def emissive(b):
    white = b.matte(kd=(0.73, 0.73, 0.73))
    b.add_quad([0, 0, 0], [1, 0, 0], [1, 0, -1], [0, 0, -1], white)
    b.add_quad([0, 0, -1], [1, 0, -1], [1, 1, -1], [0, 1, -1], white)
    proto = b.instanced_prototype(QUAD_V, QUAD_I)
    b.add_instance(proto, b.matte(kd=(0.0, 0.0, 0.0)), _translate(0.5, 0.99, -0.5),
                   emit=(10.0, 10.0, 10.0))


SCENES = {"two_instances": two_instances, "rotated_scaled": rotated_scaled,
          "animated": animated, "spinning": spinning, "field": field, "emissive": emissive}


def build(make, bvh=False):
    """(JAX scene, the port's scene built natively on the CPU)."""
    jb, tb = JBuilder(), TBuilder()
    make(jb)
    make(tb)
    return jb.build(), tb.build(bvh=bvh, device="cpu", tile=TILE)


def bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


@pytest.mark.parametrize("name", list(SCENES))
def test_builders_agree_bit_for_bit(name):
    """The same calls on both builders: every InstanceSet column, the
    world bounds and the light table bit for bit; one stored prototype."""
    js, ts = build(SCENES[name])
    assert len(ts.instances) == len(js.instances)
    for j, t in zip(js.instances, ts.instances):
        assert t.count == j.count and t.animated == j.animated
        assert t.proto.count == j.proto.indices.shape[0]
        for k, _ in tinst.COLUMNS:
            a, b = getattr(t, k).numpy(), np.asarray(getattr(j, k))
            if a.dtype.kind == "f":
                np.testing.assert_array_equal(bits(a), bits(b), err_msg=k)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(bits(t.proto.shade_rec), bits(j.proto.shade_rec))
    np.testing.assert_array_equal(bits(ts.world_center), bits(js.world_center))
    assert np.float32(ts.world_radius) == np.float32(js.world_radius)
    for k in ("kind", "emit", "prim_count", "total_area", "em_tri_idx", "em_tri_cdf",
              "em_tri_p", "two_sided"):
        np.testing.assert_array_equal(getattr(ts.lights, k).numpy(),
                                      np.asarray(getattr(js.lights, k)), err_msg=k)
    # the bridge carries the JAX scene's sets as they are
    bs = bridge.scene_from_numpy(scene_tree(js), "cpu", tile=TILE)
    for j, t in zip(js.instances, bs.instances):
        for k, _ in tinst.COLUMNS:
            np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)))


def test_animated_scale_is_refused():
    b = TBuilder()
    proto = b.instanced_prototype(*_icosphere(0.4, 1))
    b.add_instance(proto, b.matte(kd=0.5), np.eye(4), transform1=np.diag([2.0, 1, 1, 1]))
    with pytest.raises(ValueError):
        b.build(device="cpu")
    with pytest.raises(ValueError):
        b.add_instance(proto, 0, np.eye(4), transform1=_translate(1, 0, 0), emit=(1, 1, 1))


def _rays(js, n, seed):
    """Rays aimed at the instances' boxes (jittered) and a few at random,
    with per-lane times in [0, 1] (some exactly 0 and 1)."""
    r = np.random.RandomState(seed)
    c = np.concatenate([np.asarray((s.bmin + s.bmax) / 2) for s in js.instances])
    target = c[r.randint(0, len(c), n)] + r.randn(n, 3) * 0.25
    o = target + r.randn(n, 3) / np.sqrt(3) * 3.0
    d = target - o
    d[: n // 8] = r.randn(n // 8, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    time = r.rand(n)
    time[:4], time[4:8] = 0.0, 1.0
    tmax = np.where(r.rand(n) < 0.5, 1e30, r.uniform(0.5, 4.0, n))
    return [x.astype(np.float32) for x in (o, d, time, tmax)]


HIT_FIELDS = ("t", "p", "ng", "ns", "uv", "dpdu", "uv_scale")
ID_FIELDS = ("valid", "material_id", "light_id", "prim_kind", "prim_id")


def _assert_hits(th, jh):
    v = np.asarray(jh.valid)
    for k in ID_FIELDS:
        np.testing.assert_array_equal(getattr(th, k).numpy(), np.asarray(getattr(jh, k)),
                                      err_msg=k)
    for k in HIT_FIELDS:
        np.testing.assert_allclose(getattr(th, k).numpy()[v], np.asarray(getattr(jh, k))[v],
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    np.testing.assert_array_equal(np.isinf(th.t.numpy()), np.isinf(np.asarray(jh.t)))


@pytest.fixture(scope="module")
def query_scenes():
    return {k: build(SCENES[k]) for k in ("two_instances", "rotated_scaled", "animated",
                                          "spinning", "emissive")}


@pytest.mark.parametrize("name", ["two_instances", "rotated_scaled", "animated", "spinning",
                                  "emissive"])
def test_queries_brute_force(name, query_scenes):
    """intersect, occluded and intersect_occluded per lane against the JAX
    package's (which traces prototypes brute force, as the port does for
    a scene built without bvh)."""
    js, ts = query_scenes[name]
    n = 192
    o, d, time, tmax = _rays(js, n, seed=len(name))
    tmin = np.full(n, 1e-4, np.float32)
    d2 = np.roll(d, 7, axis=0)     # shadow rays of other directions

    def queries(o, d, d2, tmin, tmax, time):
        return (jscene.intersect(js, o, d, time=time),
                jscene.occluded(js, o, d, t_min=tmin, t_max=tmax, time=time),
                jscene.intersect_occluded(js, o, d, o, d2, tmax, time=time))

    args = (o, d, d2, tmin, tmax, time)
    with reference_jit():     # one compile of the three queries
        jh, jo, (jh2, jo2) = jax.jit(queries)(*map(jnp.asarray, args))
    T = torch.as_tensor
    th = tscene.intersect(ts, T(o), T(d), time=T(time))
    _assert_hits(th, jh)
    assert np.asarray(jh.valid).mean() > 0.25
    to = tscene.occluded(ts, T(o), T(d), t_min=T(tmin), t_max=T(tmax), time=T(time))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    th2, to2 = tscene.intersect_occluded(ts, T(o), T(d), T(o), T(d2), T(tmax), time=T(time))
    _assert_hits(th2, jh2)
    np.testing.assert_array_equal(to2.numpy(), np.asarray(jo2))


@pytest.mark.parametrize("name", ["two_instances", "spinning", "emissive"])
def test_queries_cluster_route(name):
    """Built with bvh: the scene pool and each prototype through the cluster
    tracer, against the JAX package's brute force within
    tests/test_torch_cluster.py's tolerances."""
    js, ts = build(SCENES[name], bvh=True)
    assert all(s.clusters is not None for s in ts.instances)
    n = 512
    o, d, time, tmax = _rays(js, n, seed=11)
    J, T = (lambda a: jnp.asarray(a)), torch.as_tensor   # noqa: E731
    d2 = np.roll(d, 5, axis=0)
    with reference_jit():
        jh, jo = jax.jit(lambda *a: jscene.intersect_occluded(js, *a[:5], time=a[5]))(
            J(o), J(d), J(o), J(d2), J(tmax), J(time))
    th, to = tscene.intersect_occluded(ts, T(o), T(d), T(o), T(d2), T(tmax), time=T(time))
    jv, tv = np.asarray(jh.valid), th.valid.numpy()
    assert (jv == tv).mean() > 0.995 and jv.mean() > 0.25
    both = jv & tv
    same = (th.prim_id.numpy() == np.asarray(jh.prim_id)) \
        & (th.material_id.numpy() == np.asarray(jh.material_id))
    assert same[both].mean() > 0.99
    np.testing.assert_allclose(th.t.numpy()[both], np.asarray(jh.t)[both], rtol=1e-3)
    assert (to.numpy() == np.asarray(jo)).mean() > 0.995
    occ = tscene.occluded(ts, T(o), T(d2), t_max=T(tmax), time=T(time)).numpy()
    assert (occ == np.asarray(jo)).mean() > 0.995


def test_tie_goes_to_the_earlier_instance():
    """Two coincident instances of different materials: every lane takes
    the first, as the JAX package's sequential strict-< merge does."""
    def twins(b):
        proto = b.instanced_prototype(*_icosphere(0.5, 1))
        m0, m1 = b.matte(kd=0.2), b.matte(kd=0.8)
        b.add_instance(proto, m0, np.eye(4))
        b.add_instance(proto, m1, np.eye(4))

    tb = TBuilder()
    twins(tb)
    r = np.random.RandomState(2)
    o = np.tile([[0.0, 0.0, -3.0]], (64, 1)).astype(np.float32)
    d = (np.array([0, 0, 1.0]) + r.randn(64, 3) * 0.1).astype(np.float32)
    for bvh in (False, True):
        ts = tb.build(bvh=bvh, device="cpu", tile=TILE)
        th = tscene.intersect(ts, torch.as_tensor(o), torch.as_tensor(d))
        assert th.valid.sum() > 32 and (th.material_id[th.valid] == 0).all()


def _jax_instance_pass(iset, o, d, t_min, t_max):
    """The JAX package's instance pass (geom/scene.py:234-283) through its
    own per-instance functions, instance by instance in eager mode (its
    scene query compiles one lax.cond an instance: minutes for 100):
    entered, then intersect_one into a strict-< merge."""
    n = o.shape[0]
    best = jnp.asarray(t_max)
    out = dict(valid=np.zeros(n, bool), t=np.full(n, np.inf, np.float32),
               prim_id=np.full(n, -1), ng=np.zeros((n, 3), np.float32),
               p=np.zeros((n, 3), np.float32))
    for i in range(iset.count):
        enter = jinst.entered(iset, i, o, d, t_min, best)
        if not bool(jnp.any(enter)):
            continue
        h, t, sh = jinst.intersect_one(iset, i, o, d, None, t_min, jnp.where(enter, best, -1.0))
        take = np.asarray(h & (t < best))
        out["valid"] |= take
        out["t"] = np.where(take, np.asarray(t), out["t"])
        out["prim_id"] = np.where(take, np.asarray(sh["prim_id"]), out["prim_id"])
        for k in ("ng", "p"):
            out[k] = np.where(take[:, None], np.asarray(sh[k]), out[k])
        best = jnp.where(take, t, best)
    return out


def test_field_through_the_precull():
    """The 100-instance field: the (I, N) pre-cull mask equals the JAX
    package's entered() for every instance; a narrow bundle aimed at
    instance 0 enters a handful of instances' boxes and the pair wavefront
    holds only those pairs; a wide bundle's hits equal the JAX package's
    instance pass per lane, and equal the port's own with the cull off
    (inflated boxes); the cluster route agrees within
    tests/test_torch_cluster.py's tolerances."""
    import dataclasses
    js, ts = build(field)
    jset, iset = js.instances[0], ts.instances[0]
    r = np.random.RandomState(7)
    c0 = iset.t0[0].numpy().astype(np.float64)
    n = 64
    o = np.tile(c0 + [0, 0, 20], (n, 1)).astype(np.float32)
    d = (np.array([0, 0, -20.0]) + r.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    T, J = torch.as_tensor, jnp.asarray
    inst, _ = tinst.pairs(iset, T(o), T(d), torch.zeros(n), torch.full((n,), 1e30))
    assert len(set(inst.tolist())) <= 5 and (inst == 0).sum() == n
    assert tscene.intersect(ts, T(o), T(d)).valid.all()
    # a wide bundle from the field's front, toward 8 instances picked at random
    o2 = np.tile([[0.0, 0.0, 20.0]], (n, 1)).astype(np.float32)
    aim = iset.t0.numpy()[r.choice(iset.count, 8, replace=False)[r.randint(0, 8, n)]] \
        + r.uniform(-0.5, 0.5, (n, 3))
    d2 = (aim - o2).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    tmin, tmax = np.full(n, 1e-4, np.float32), np.full(n, np.inf, np.float32)
    mask = tinst.entered(iset, T(o2), T(d2), T(tmin), T(tmax)).numpy()
    jmask = np.stack([np.asarray(jinst.entered(jset, i, J(o2), J(d2), J(tmin), J(tmax)))
                      for i in range(jset.count)])
    np.testing.assert_array_equal(mask, jmask)
    hit = tscene.intersect(ts, T(o2), T(d2))
    ref = _jax_instance_pass(jset, J(o2), J(d2), J(tmin), J(tmax))
    assert ref["valid"].sum() > n // 4
    np.testing.assert_array_equal(hit.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(hit.prim_id.numpy()[ref["valid"]],
                                  ref["prim_id"][ref["valid"]])
    for k in ("t", "p", "ng"):
        np.testing.assert_allclose(getattr(hit, k).numpy()[ref["valid"]],
                                   ref[k][ref["valid"]], rtol=RTOL, atol=ATOL)
    big = dataclasses.replace(iset, bmin=torch.full_like(iset.bmin, -1e30),
                              bmax=torch.full_like(iset.bmax, 1e30))
    nocull = tscene.intersect(dataclasses.replace(ts, instances=(big,)), T(o2), T(d2))
    np.testing.assert_array_equal(hit.t.numpy(), nocull.t.numpy())
    _, tc = build(field, bvh=True)
    hc = tscene.intersect(tc, T(o2), T(d2))
    assert (hc.valid == hit.valid).float().mean() > 0.995
    both = (hc.valid & hit.valid).numpy()
    np.testing.assert_allclose(hc.t.numpy()[both], hit.t.numpy()[both], rtol=1e-3)


def test_emissive_instance_light_row():
    """sample_li, pdf_li_area_scene, sample_le and power on the emissive
    instance's light row (corner rows, no scene triangle ids) against the
    JAX package's, per lane at rtol 1e-4, atol 1e-6."""
    from pbrt_tpu.lights import lights as jl
    from pbrt_tpu_torch.lights import lights as tl
    js, ts = build(emissive)
    assert int(ts.lights.em_tri_idx.max()) == -1 and int(ts.lights.prim_count[0]) == 2
    r = np.random.RandomState(9)
    n = 1024
    lt = np.zeros(n, np.int64)
    p_ref = (r.rand(n, 3) * [1.0, 0.9, -1.0]).astype(np.float32)
    u2, u3 = r.rand(n, 2).astype(np.float32), r.rand(n, 2).astype(np.float32)
    J, T = jnp.asarray, torch.as_tensor
    close = lambda a, b, k: np.testing.assert_allclose(  # noqa: E731
        a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6, err_msg=k)
    def reference(lt, p_ref, u2, u3):
        ls = jl.sample_li(js.lights, js, lt, p_ref, u2, js.world_radius)
        return ls, jl.pdf_li_area_scene(js.lights, js, lt, p_ref, ls["p_light"], ls["ng_l"]), \
            jl.sample_le(js.lights, js, lt, u2, u3, js.world_radius)

    with reference_jit():      # one compile of the three
        jls, jpdf, jle = jax.jit(reference)(J(lt), J(p_ref), J(u2), J(u3))
    tls = tl.sample_li(ts.lights, ts, T(lt), T(p_ref), T(u2), ts.world_radius)
    for k in ("wi", "li", "pdf", "p_light", "dist", "ng_l"):
        close(tls[k], jls[k], k)
    assert (tls["li"].sum(-1) > 0).float().mean() > 0.5
    close(tl.pdf_li_area_scene(ts.lights, ts, T(lt), T(p_ref), T(np.asarray(jls["p_light"])),
                               T(np.asarray(jls["ng_l"]))), jpdf, "pdf_li_area_scene")
    tle = tl.sample_le(ts.lights, ts, T(lt), T(u2), T(u3), ts.world_radius)
    for k in ("o", "d", "ng_l", "le", "pdf_pos", "pdf_dir"):
        close(tle[k], jle[k], k)
    close(tl.power(ts.lights, ts.world_radius), jl.power(js.lights, js.world_radius), "power")


def _camera(res):
    c2w = jtf.look_at(np.array([0.0, 0.0, -3.0]), np.zeros(3), np.array([0.0, 1.0, 0.0]))
    return jmake_perspective(c2w, 50.0, (res, res))


def test_path_render_of_the_animated_instance():
    """Path at depth 2, 16×16, 4 spp (stratified): the shutter time from
    the sampler's stream (DIM_TIME, raw), the pixel check against
    pbrt_tpu; the moving sphere smears wider than the static one."""
    res, spp = 16, 4
    jcam = _camera(res)
    tcam = bridge.camera_from_numpy(camera_dict(jcam), "cpu")
    jc = jdriver.RenderConfig(width=res, height=res, spp=spp, max_depth=2,
                              sampler=jsmp.SamplerConfig(kind="stratified", spp=spp))
    tc = tdriver.RenderConfig(width=res, height=res, spp=spp, max_depth=2,
                              sampler=tsmp.SamplerConfig(kind="stratified", spp=spp))
    js, ts = build(animated)
    with reference_jit():
        ij = np.asarray(jdriver.render(js, jcam, jc, jpath.make_li(jc)))
    it = tdriver.render(ts, tcam, tc, tpath.make_li(tc)).numpy()
    _check(it, ij)
    _, ts_static = build(lambda b: animated(b, moving=False))
    i_static = tdriver.render(ts_static, tcam, tc, tpath.make_li(tc)).numpy()
    cover = lambda img: (img.mean(axis=2).min(axis=0) < 0.9).sum()  # noqa: E731
    assert cover(it) > cover(i_static)


def test_direct_render_of_the_emissive_instance():
    """Direct lighting ("all") of the box lit only by an emissive instance,
    16×16, 4 spp: the pixel check against pbrt_tpu."""
    from pbrt_tpu_torch.scenes import cornell_camera
    from scenes.cornell import cornell_camera as jcornell_camera
    res, spp = 16, 4
    jcam = jcornell_camera((res, res))
    tcam = cornell_camera((res, res), "cpu")
    jc = jdriver.RenderConfig(width=res, height=res, spp=spp, max_depth=1,
                              sampler=jsmp.SamplerConfig(kind="zerotwo", spp=spp))
    tc = tdriver.RenderConfig(width=res, height=res, spp=spp, max_depth=1,
                              sampler=tsmp.SamplerConfig(kind="zerotwo", spp=spp))
    js, ts = build(emissive)
    with reference_jit():
        ij = np.asarray(jdriver.render(js, jcam, jc, jdirect.make_li(jc)))
    it = tdriver.render(ts, tcam, tc, tdirect.make_li(tc)).numpy()
    assert ij.mean() > 0.01
    _check(it, ij)
