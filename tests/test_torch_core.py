"""PyTorch port vs the JAX package: RNG, samplers, warps, camera rays.

Integer streams must be equal bit for bit; floats allclose. Inputs are
made with numpy and handed to both packages."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.core import rng as jrng
from pbrt_tpu.core import samplers as jsmp
from pbrt_tpu.core import lowdiscrepancy as jld
from pbrt_tpu.core import sampling as jsampling
from pbrt_tpu.core.spectrum import luminance as jluminance
from pbrt_tpu.core.types import find_interval as jfind_interval
from pbrt_tpu.film import filters as jfilters
from pbrt_tpu.cameras import cameras as jcam
from scenes.bunny import mesh_camera

from pbrt_tpu_torch.core import rng as trng
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.core import lowdiscrepancy as tld
from pbrt_tpu_torch.core import sampling as tsampling
from pbrt_tpu_torch.core.spectrum import luminance as tluminance
from pbrt_tpu_torch.core.types import find_interval as tfind_interval
from pbrt_tpu_torch.film import filters as tfilters
from pbrt_tpu_torch.integrate import driver as tdriver
from pbrt_tpu_torch import bridge, scenes as tscenes
from pbrt_tpu_torch.cameras import cone_start as tcone_start


def _u32(n, seed):
    r = np.random.RandomState(seed)
    x = r.randint(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF]
    return x


def test_pcg_hash_and_combine_bit_exact():
    a, b, c = _u32(4096, 0), _u32(4096, 1), _u32(4096, 2)
    ta, tb, tc = (torch.as_tensor(x.astype(np.int64)) for x in (a, b, c))
    np.testing.assert_array_equal(
        np.asarray(jrng.pcg_hash(jnp.asarray(a))), trng.pcg_hash(ta).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.hash_combine(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c))),
        trng.hash_combine(ta, tb, tc).numpy())
    np.testing.assert_array_equal(
        np.asarray(jrng.uniform_float(jnp.uint32(3), jnp.asarray(a), jnp.asarray(b))),
        trng.uniform_float(3, ta, tb).numpy())


def test_sobol_direction_vectors_match():
    """All 160 dimensions of the generated table."""
    np.testing.assert_array_equal(tld.sobol_matrices(),
                                  jld.sobol_matrices().astype(np.int64))


@pytest.mark.parametrize("kind", ["zerotwo", "random"])
@pytest.mark.parametrize("seed", [0, 5])
def test_sampler_streams_exact(kind, seed):
    """sample_1d / sample_2d over a (pixel, sample, dim) grid."""
    pix = np.arange(0, 4096, 37, dtype=np.uint32)
    smp_i = np.array([0, 1, 2, 3, 7, 8, 100, 65535, 2 ** 31 + 11], np.uint32)
    P, S = np.meshgrid(pix, smp_i, indexing="ij")
    P, S = P.reshape(-1), S.reshape(-1)
    jcfg = jsmp.SamplerConfig(kind=kind, spp=1, seed=seed)
    tcfg = tsmp.SamplerConfig(kind=kind, spp=1, seed=seed)
    tp, ts = torch.as_tensor(P.astype(np.int64)), torch.as_tensor(S.astype(np.int64))
    for dim in (0, 2, 4, tsmp.bounce_dim(0, 0), tsmp.bounce_dim(3, 6), 8000 + 4, 9000 + 1):
        np.testing.assert_array_equal(
            np.asarray(jsmp.sample_1d(jcfg, jnp.asarray(P), jnp.asarray(S), dim)),
            tsmp.sample_1d(tcfg, tp, ts, dim).numpy())
        np.testing.assert_array_equal(
            np.asarray(jsmp.sample_2d(jcfg, jnp.asarray(P), jnp.asarray(S), dim)),
            tsmp.sample_2d(tcfg, tp, ts, dim).numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 64), (4097,)])
def test_prefix_sum_matches_a_float64_cumsum(shape):
    """sampling.prefix_sum (the cdfs' scan) along the last axis, against
    numpy's cumsum in float64, rtol 1e-6."""
    x = np.random.RandomState(6).rand(*shape).astype(np.float32)
    got = tsampling.prefix_sum(torch.as_tensor(x)).numpy()
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.cumsum(x.astype(np.float64), -1), rtol=1e-6)


@pytest.mark.parametrize("per_lane", [False, True])
def test_find_interval_matches_jax(per_lane):
    """The port's search of sorted cdfs equals the reference's count of
    entries <= x, one cdf for every x or one cdf a lane: flat runs (zero
    func entries), x on an entry, below the first and past the last."""
    r = np.random.RandomState(5)
    n, m = 4096, 17
    func = r.rand(n if per_lane else 1, m).astype(np.float32)
    func[func < 0.3] = 0.0
    cdf = np.concatenate([np.zeros_like(func[:, :1]), np.cumsum(func, -1)], -1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    cdf = cdf if per_lane else cdf[0]
    x = r.rand(n).astype(np.float32)
    x[:64] = (cdf[:64, 5] if per_lane else cdf[r.randint(0, m + 1, 64)])
    x[64:68] = [-0.5, 0.0, 1.0, 1.5]
    got = tfind_interval(torch.as_tensor(cdf), torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jfind_interval(jnp.asarray(cdf), jnp.asarray(x))))
    assert len(np.unique(got)) > m // 2


def test_warps_heuristic_distribution_luminance():
    r = np.random.RandomState(3)
    u = r.rand(2000, 2).astype(np.float32)
    u[:3] = [[0.5, 0.5], [0.0, 0.0], [0.999, 0.001]]
    tu = torch.as_tensor(u)
    np.testing.assert_allclose(tsampling.concentric_sample_disk(tu).numpy(),
                               np.asarray(jsampling.concentric_sample_disk(jnp.asarray(u))),
                               atol=1e-6)
    # cos/sin differ by an ulp between XLA and PyTorch; z = sqrt(1 - r²)
    # amplifies that near the horizon, hence 2e-6
    np.testing.assert_allclose(tsampling.cosine_sample_hemisphere(tu).numpy(),
                               np.asarray(jsampling.cosine_sample_hemisphere(jnp.asarray(u))),
                               atol=2e-6)
    a, b = (r.rand(500).astype(np.float32) * 5 for _ in range(2))
    np.testing.assert_allclose(
        tsampling.power_heuristic(1.0, torch.as_tensor(a), 1.0, torch.as_tensor(b)).numpy(),
        np.asarray(jsampling.power_heuristic(1.0, jnp.asarray(a), 1.0, jnp.asarray(b))),
        rtol=1e-6)
    func = r.rand(3, 17).astype(np.float32)
    func[1] = 0.0
    jd = jsampling.Distribution1D.build(jnp.asarray(func))
    td = tsampling.Distribution1D.build(torch.as_tensor(func))
    np.testing.assert_allclose(td.cdf.numpy(), np.asarray(jd.cdf), rtol=1e-6, atol=1e-7)
    uu = r.rand(3).astype(np.float32)
    for jx, tx in zip(jd.sample_continuous(jnp.asarray(uu)),
                      td.sample_continuous(torch.as_tensor(uu))):
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    rgb = r.rand(100, 3).astype(np.float32)
    np.testing.assert_allclose(tluminance(torch.as_tensor(rgb)).numpy(),
                               np.asarray(jluminance(jnp.asarray(rgb))), rtol=1e-6)
    off, wt = tfilters.sample_offset(tfilters.Filter(), tu)
    joff, jwt = jfilters.sample_offset(jfilters.Filter(), jnp.asarray(u))
    np.testing.assert_array_equal(off.numpy(), np.asarray(joff))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(jwt))


def _jax_camera_rays(cam, res):
    """Camera rays of the JAX package's lane raygen at spp=1, zerotwo."""
    from pbrt_tpu.dist.sharding import _render_lanes
    from pbrt_tpu.integrate import driver as jdriver
    cfg = jdriver.RenderConfig(width=res, height=res, spp=1,
                               sampler=jsmp.SamplerConfig(kind="zerotwo", spp=1))
    out = {}

    def li(scene, o, d, pid, sid):
        out["o"], out["d"] = o, d
        return jnp.zeros(o.shape)
    pid = jnp.arange(res * res, dtype=jnp.uint32)[None]
    _render_lanes(None, cam, cfg, li, pid, jnp.zeros_like(pid))
    return np.asarray(out["o"]).reshape(-1, 3), np.asarray(out["d"]).reshape(-1, 3)


def _camera_dict(cam):
    return dict(camera_to_world=tuple(np.asarray(x) for x in cam.camera_to_world),
                raster_to_camera=tuple(np.asarray(x) for x in cam.raster_to_camera),
                lens_radius=cam.lens_radius, focal_distance=cam.focal_distance,
                shutter_open=cam.shutter_open, shutter_close=cam.shutter_close,
                area=cam.area, resolution=cam.resolution)


def _port_camera_rays(cam, res):
    cfg = tdriver.RenderConfig(width=res, height=res, spp=1,
                               sampler=tsmp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = tdriver.lane_ids(cfg, 0, 1, "cpu")
    o, d, cw, fw = tdriver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    return o.numpy(), d.numpy()


def test_camera_rays_64():
    res = 64
    jc = mesh_camera((res, res))
    jo, jd = _jax_camera_rays(jc, res)
    # the JAX camera's own matrices, carried across
    o, d = _port_camera_rays(bridge.camera_from_numpy(_camera_dict(jc), "cpu"), res)
    np.testing.assert_allclose(o, jo, atol=1e-6)
    np.testing.assert_allclose(d, jd, atol=1e-6)
    # the port's own camera (matrices built in float64)
    o, d = _port_camera_rays(tscenes.bench_camera((res, res), "cpu"), res)
    np.testing.assert_allclose(o, jo, atol=1e-6)
    np.testing.assert_allclose(d, jd, atol=1e-6)
    jw, js_ = jcam.cone_start(jc)
    tw, ts_ = tcone_start(tscenes.bench_camera((res, res), "cpu"))
    np.testing.assert_allclose([tw, ts_], [float(jw), float(js_)], rtol=1e-6)
