"""The roofline's frozen work count on a small bench wavefront on the
CPU: against a per-lane count written out in numpy, and against the
port's own counter (`needed_tests` of the plain tracers), which counts
more by design: a pair is needed there when the tile's least entry t
lies within the lane's best t at the start of its round, and each pair
counts K slots, padding included."""
import numpy as np
import pytest
import torch

from pbench import roofline


@pytest.fixture(scope="module")
def wavefront():
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.cameras import generate_rays
    from pbrt_tpu_torch.geom import cluster as clmod
    scene = scenes.bench_scene(3, device="cpu", tile=256)
    cam = scenes.bench_camera((24, 24), "cpu")
    ys, xs = torch.meshgrid(torch.arange(24.0), torch.arange(24.0), indexing="ij")
    pfilm = torch.stack([xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5], -1)
    n = pfilm.shape[0]
    o, d, _ = generate_rays(cam, pfilm, torch.full((n, 2), 0.5), torch.zeros(n))
    t_min = torch.full((n,), 1e-4)
    t_max = torch.full((n,), float("inf"))
    t_max[::7] = -1.0                     # some dead lanes
    return scene, clmod, o.contiguous(), d.contiguous(), t_min, t_max


def _needed(clmod, cs, o, d, t_min, t_max, tile, anyhit):
    from pbrt_tpu_torch.kernels import cluster_cuda as kern
    order, rays, _ = clmod.prepare(cs, o, d, t_min, t_max, tile)
    corder, tnear, counts, covbits = clmod.tile_cluster_order(cs, rays, tile)
    needed = torch.zeros(1, dtype=torch.int64)
    if anyhit:
        kern.occluded_plain(cs.packed, rays, corder, tnear, counts, covbits, tile,
                            needed_tests=needed)
    else:
        kern.closest_plain(cs.packed, rays, None, corder, tnear, counts, covbits, tile,
                           needed_tests=needed)
    return int(needed)


def _per_lane(cs, o, d, t_min, t_end, first_only):
    """The count written out lane by lane in float64 numpy."""
    c = cs.n_clusters
    b = cs.bounds[:, :c].double().numpy()
    ntri = (cs.packed[:, 18:21, :] != 0).any(1).sum(1).numpy()
    tot = 0
    for i in range(o.shape[0]):
        if not t_min[i] < t_end[i] and not first_only[i]:
            continue
        oo, dd = o[i].double().numpy(), d[i].double().numpy()
        dd = np.where(np.abs(dd) < 1e-12, np.where(dd < 0, -1e-12, 1e-12), dd)
        a = (b[0::2].T - oo) / dd
        z = (b[1::2].T - oo) / dd
        tn = np.maximum(np.minimum(a, z).max(1), float(t_min[i]))
        tf = np.minimum(np.maximum(a, z).min(1), float(t_end[i]))
        ent = tn <= tf
        if first_only[i] and ent.any():
            tot += ntri[np.argmin(np.where(ent, tn, np.inf))]
        elif not first_only[i]:
            tot += ntri[ent].sum()
    return tot


def test_closest_count(wavefront):
    scene, clmod, o, d, t_min, t_max = wavefront
    cs = scene.clusters
    hit, t, *_ = clmod.intersect(cs, o, d, t_min, t_max, scene.tile)
    ops, nbytes, n_any = roofline.work(("closest", cs, o, d, t_min, t_max, None, hit, t))
    assert n_any == 0
    count = ops / roofline.OPS_CLOSEST
    t_end = torch.where(hit, t, t_max)
    assert count == _per_lane(cs, o, d, t_min, t_end, torch.zeros_like(hit))
    needed = _needed(clmod, cs, o, d, t_min, t_max, scene.tile, anyhit=False)
    assert 0 < count <= needed
    live = int((t_max > t_min).sum())
    assert nbytes >= live * (32 + 16)


def test_any_hit_count(wavefront):
    scene, clmod, o, d, t_min, t_max = wavefront
    cs = scene.clusters
    hit, t, *_ = clmod.intersect(cs, o, d, t_min, t_max, scene.tile)
    # half the lanes stop short of their hit, half reach past it
    scale = torch.where(torch.arange(t.shape[0]) % 2 == 0, 0.9, 1.1)
    t_sh = torch.where(hit, t * scale, 3.0)
    t_sh[::7] = -1.0
    occ = clmod.occluded(cs, o, d, t_min, t_sh, scene.tile)
    assert occ.any() and (~occ).any()
    ops, _, n_any = roofline.work(("occluded", cs, o, d, t_min, t_sh, None, occ, None))
    assert n_any == int((t_sh > t_min).sum())
    count = ops / roofline.OPS_ANY
    assert count == _per_lane(cs, o, d, t_min, t_sh, occ)
    assert 0 < count <= _needed(clmod, cs, o, d, t_min, t_sh, scene.tile, anyhit=True)


def test_capture_restores_the_boundary(wavefront):
    scene, clmod, o, d, t_min, t_max = wavefront
    trace0, occ0 = clmod._trace, clmod.occluded
    cap = roofline.Capture(clmod)
    with cap.active():
        clmod.intersect(scene.clusters, o, d, t_min, t_max, scene.tile)
        clmod.occluded(scene.clusters, o, d, t_min, t_max, scene.tile)
    assert (clmod._trace, clmod.occluded) == (trace0, occ0)
    assert [c[0] for c in cap.calls] == ["closest", "occluded"]
    s = roofline.summarize(cap, "closest")
    assert s["calls"] == 1 and s["least_s"] > 0 and s["bound"] in ("ops", "bytes")


def test_least_time_is_the_larger_bound():
    assert roofline.least_seconds(67e12, 0.0) == (1.0, "ops")
    assert roofline.least_seconds(0.0, 3.35e12) == (1.0, "bytes")
