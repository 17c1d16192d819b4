"""The PyTorch port's direct-lighting and ambient-occlusion integrators vs
the JAX package on the bench scene, and one lane-level comparison of MIS
direct lighting.

Renders: mesh_scene(subdivisions=2) in the JAX package, the port's native
bench_scene(2), 32×32, 2 spp, zerotwo sampler, held to the pixel check of
tests/test_oracle.py (0.995 of pixels within 2e-3 relative, mean
difference under 1e-3). Both packages draw the same sample streams; the
JAX package traces with its lock-step tracer on the CPU, the port with
the plain versions of its kernels (any hit for every shadow ray).

Lane level: the same hit records and uniforms through both packages'
estimate_direct, rtol 1e-4 with atol 1e-6 (transcendentals differ by an
ulp between XLA and PyTorch)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.geom import scene as jscene
from pbrt_tpu.integrate import ao as jao, common as jcommon, direct as jdirect
from pbrt_tpu.integrate import driver as jdriver
from pbrt_tpu.shade import materials as jmat
from scenes.bunny import mesh_scene, mesh_camera
from tests.test_oracle import _check
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.integrate import ao as tao, common as tcommon, direct as tdirect
from pbrt_tpu_torch.integrate import driver as tdriver
from pbrt_tpu_torch.geom import scene as tscene
from pbrt_tpu_torch.kernels import cluster_cuda as tkern
from pbrt_tpu_torch.scenes import bench_camera, bench_scene
from pbrt_tpu_torch.shade import materials as tmat

TILE = int(os.environ.get("PBRT_TPU_TILE", 256))
RES, SPP, SUBDIV = 32, 2, 2

CASES = {
    "direct_one": (lambda c: jdirect.make_li(c, "one"), lambda c: tdirect.make_li(c, "one")),
    "direct_all": (lambda c: jdirect.make_li(c, "all"), lambda c: tdirect.make_li(c, "all")),
    "ao_cosine": (lambda c: jao.make_li(c, True), lambda c: tao.make_li(c, True)),
    "ao_uniform": (lambda c: jao.make_li(c, False), lambda c: tao.make_li(c, False)),
}


@pytest.fixture(scope="module")
def scenes():
    js = mesh_scene(subdivisions=SUBDIV, use_bvh=True)
    return (js, mesh_camera((RES, RES)), bench_scene(SUBDIV, "cpu", tile=TILE),
            bench_camera((RES, RES), "cpu"))


@pytest.mark.parametrize("case", list(CASES))
def test_render_matches_jax(scenes, case):
    js, jc, ts, tc = scenes
    make_j, make_t = CASES[case]
    jcfg = jdriver.RenderConfig(width=RES, height=RES, spp=SPP,
                                sampler=jsmp.SamplerConfig(kind="zerotwo", spp=SPP))
    tcfg = tdriver.RenderConfig(width=RES, height=RES, spp=SPP,
                                sampler=tsmp.SamplerConfig(kind="zerotwo", spp=SPP))
    img_j = np.asarray(jdriver.render(js, jc, jcfg, make_j(jcfg)))
    before = (tkern.coverage.launches, tkern.closest.launches, tkern.occluded.launches)
    img_t = tdriver.render(ts, tc, tcfg, make_t(tcfg)).numpy()
    # the CPU runs the plain versions: no kernel launch is counted
    assert (tkern.coverage.launches, tkern.closest.launches,
            tkern.occluded.launches) == before
    assert np.isfinite(img_t).all() and img_t.shape == (RES, RES, 3)
    assert img_t.mean() > 0.1
    _check(img_t, img_j)


@pytest.mark.parametrize("case", ["direct_one", "direct_all", "ao_cosine"])
def test_rays_traced_counts_live_lanes(scenes, case):
    """rays_traced, path.li's definition: every camera ray plus the rays
    that carry a share (usable shadow rays and used BSDF rays for direct
    lighting, the occlusion rays of surface hits for AO); the radiance is
    that of the call without stats."""
    ts = scenes[2]
    n_res = 16
    cfg = tdriver.RenderConfig(width=n_res, height=n_res, spp=1,
                               sampler=tsmp.SamplerConfig(kind="zerotwo", spp=1))
    cam = bench_camera((n_res, n_res), "cpu")
    pid, sid = tdriver.lane_ids(cfg, 0, 1, "cpu")
    kw = dict(strategy=case[7:]) if case.startswith("direct") else dict(cos_sample=True)
    mod = tdirect if case.startswith("direct") else tao
    img, _ = tdriver.render_lanes(ts, cam, cfg, mod.make_li(cfg, **kw), pid, sid)
    (img_s, stats), _ = tdriver.render_lanes(ts, cam, cfg,
                                             mod.make_li(cfg, **kw, return_stats=True),
                                             pid, sid)
    assert torch.equal(img, img_s)
    n = pid.numel()
    o, d, _, _ = tdriver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    valid = int(tscene.intersect(ts, o, d).valid.sum())
    rays = float(stats["rays_traced"])
    if mod is tao:
        assert rays == n + 4 * valid
    else:
        # the bench scene has one light: "all" traces what "one" does
        assert n + 0.5 * valid < rays <= n + 2 * valid


def test_estimate_direct_lane_level(scenes):
    """Same hits (the JAX package's), same uniforms; the port's shadow ray
    runs the any-hit plain version, its BSDF ray the closest-hit one."""
    js = scenes[0]
    ts = bridge.scene_from_numpy(scene_tree(js), "cpu", tile=TILE)
    r = np.random.RandomState(9)
    n = 2048
    lo, hi = np.asarray(js.clusters.world_min), np.asarray(js.clusters.world_max)
    tgt = lo + r.rand(n, 3) * (hi - lo)
    o = np.asarray(js.world_center) + np.float32(2.5 * js.world_radius) * np.float32(
        [0.3, 0.5, 0.8]) + r.randn(n, 3) * 0.2
    d = tgt - o
    o, d = o.astype(np.float32), (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    u_sel, u_lobe = r.rand(n).astype(np.float32), r.rand(n).astype(np.float32)
    u_light, u_bsdf = r.rand(n, 2).astype(np.float32), r.rand(n, 2).astype(np.float32)

    hit = jscene.intersect(js, jnp.asarray(o), jnp.asarray(d))
    frame = jcommon.shading_frame(hit, js)
    lp = jmat.resolve(js.materials, hit.material_id, hit.uv, hit.p, js.textures)
    active = hit.valid & (hit.material_id >= 0)
    lt, pmf = jcommon.select_light_uniform(js.lights, jnp.asarray(u_sel))
    ld_j = np.asarray(jcommon.estimate_direct(
        js, js.lights, lp, js.materials.kinds_present, frame, hit.p, hit.ns, hit.ng,
        -jnp.asarray(d), lt, pmf, jnp.asarray(u_light), jnp.asarray(u_bsdf),
        jnp.asarray(u_lobe), active))

    T = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
    tframe = tcommon.Frame(T(frame.t), T(frame.b), T(frame.n))
    tlp = tmat.resolve(ts.materials, T(hit.material_id).long(), T(hit.uv), T(hit.p),
                       ts.textures)
    tlt, tpmf = tcommon.select_light_uniform(ts.lights, T(u_sel))
    assert torch.equal(tlt, T(lt).long()) and torch.equal(tpmf, T(pmf))
    ld_t = tcommon.estimate_direct(ts, ts.lights, tlp, ts.materials.kinds_present, tframe,
                                   T(hit.p), T(hit.ns), T(hit.ng), -T(d), tlt, tpmf,
                                   T(u_light), T(u_bsdf), T(u_lobe), T(active)).numpy()
    assert np.asarray(active).mean() > 0.5 and (ld_j.max(-1) > 0).mean() > 0.2
    np.testing.assert_allclose(ld_t, ld_j, rtol=1e-4, atol=1e-6)
