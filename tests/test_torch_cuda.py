"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports neither JAX nor the JAX package, so it runs on a machine
with a GPU and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Without a CUDA device each test skips (the kernels have no CPU mode)."""
import numpy as np
import pytest
import torch

from pbrt_tpu_torch.geom import cluster as tcl
from pbrt_tpu_torch.kernels import cluster_cuda as tkern
from pbrt_tpu_torch.kernels import probes

TILE = 256


def _soup_and_rays(seed, n=3000):
    r = np.random.RandomState(seed)
    centers = r.rand(600, 3) * 10
    verts = (centers[:, None] + 0.5 * (r.rand(600, 3, 3) - 0.5)).reshape(-1, 3)
    idx = np.arange(len(verts)).reshape(-1, 3)
    o = r.rand(n, 3) * 10
    d = r.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(r.rand(n) < 0.2, -1.0, np.where(r.rand(n) < 0.5, np.inf, 4.0))
    flag = (r.rand(n) < 0.5).astype(np.float32)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device="cuda")  # noqa: E731
    return (verts.astype(np.float32), idx.astype(np.int32), f(o), f(d),
            f(np.full(n, 1e-4)), f(t_max), f(flag))


def adversarial_coverage_case(n_clusters, tile, device, seed=7):
    """Coverage inputs that sit on the slab test's edges: rays (8, 3·tile)
    of three tiles, the last one dead (n_live_tiles = 2, its rays would
    enter boxes), bounds (6, CPAD) with CPAD the next multiple of 128
    (pad columns zero: the zero box at the origin), n_live_tiles (1,).
    Boxes: random, one flat in y (a quad), one a point, one with a face
    on x = 0, one inverted on x (lo > hi), one around the origin. Live
    lanes in turn: random; direction components exactly 0; components
    ±1e-13 (below the 1e-12 clamp); origins on a box face; origins inside
    a box; rays grazing a face (origin in the face's plane, direction
    along it); rays through the origin; tmin = 0 with a short tmax; with
    tmax = inf but for 10% dead lanes (tmax = −1)."""
    r = np.random.RandomState(seed)
    cpad = -(-n_clusters // 128) * 128
    ctr = r.rand(n_clusters, 3) * 10.0
    half = 0.1 + r.rand(n_clusters, 3) * 0.9
    lo, hi = ctr - half, ctr + half
    lo[0, 1] = hi[0, 1] = 2.0
    lo[1] = hi[1] = ctr[1]
    lo[2, 0] = 0.0
    lo[3, 0], hi[3, 0] = hi[3, 0], lo[3, 0]
    lo[4], hi[4] = -0.5, 0.5
    bounds = np.zeros((6, cpad), np.float32)
    for ax in range(3):
        bounds[2 * ax, :n_clusters] = lo[:, ax]
        bounds[2 * ax + 1, :n_clusters] = hi[:, ax]
    n = 3 * tile
    d = r.randn(n, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = r.rand(n, 3) * 14.0 - 2.0
    t_min = np.full(n, 1e-4)
    t_max = np.full(n, np.inf)
    box = r.randint(0, n_clusters, n)
    ax = r.randint(0, 3, n)
    ax2 = (ax + 1 + r.randint(0, 2, n)) % 3
    face = np.where(r.rand(n) < 0.5, bounds[2 * ax, box], bounds[2 * ax + 1, box])
    for i in range(2 * tile):
        kind = i % 9
        if kind == 1:
            d[i, ax[i]] = 0.0
            if i % 2:
                d[i, ax2[i]] = 0.0
        elif kind == 2:
            d[i, ax[i]] = 1e-13 if i % 4 < 2 else -1e-13
            if i % 2:
                d[i, ax2[i]] = -d[i, ax[i]]
        elif kind in (3, 4):
            o[i] = ctr[box[i]]
            if kind == 3:
                o[i, ax[i]] = face[i]
        elif kind == 5:
            o[i] = ctr[box[i]]
            o[i, ax[i]] = face[i]
            o[i, ax2[i]] = bounds[2 * ax2[i], box[i]] - 1.0
            d[i] = 0.0
            d[i, ax2[i]] = 1.0
        elif kind == 6:
            o[i] = -d[i] * (1.0 + 4.0 * r.rand())
        elif kind == 7:
            t_min[i] = 0.0
            t_max[i] = 0.5
    t_max[:2 * tile][r.rand(2 * tile) < 0.1] = -1.0
    rays = np.ascontiguousarray(np.concatenate([o.T, d.T, t_min[None], t_max[None]]),
                                np.float32)
    f = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return f(rays), f(bounds), f(np.array([2], np.int32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [21, 22])
def test_kernels_equal_plain_versions(card, seed):
    verts, idx, o, d, t_min, t_max, flag = _soup_and_rays(seed)
    cs = tcl.build_clusters(verts, idx, "cuda")
    _, rays, flag_s = tcl.prepare(cs, o, d, t_min, t_max, TILE, flag)
    n_live = int((rays[7] > rays[6]).sum())
    nlt = torch.tensor([-(-n_live // TILE)], dtype=torch.int32, device="cuda")
    launches = (tkern.coverage.launches, tkern.closest.launches)
    run_k, need_k, run_p, need_p = (torch.zeros(1, dtype=torch.int64, device="cuda")
                                    for _ in range(4))
    tn, cb = tkern.coverage(rays, cs.bounds, nlt, cs.n_clusters, TILE, tests_run=run_k,
                            tests_needed=need_k)
    ptn, pcb = tkern.coverage_plain(rays, cs.bounds, nlt, cs.n_clusters, TILE,
                                    tests_run=run_p, tests_needed=need_p)
    assert torch.equal(tn, ptn) and torch.equal(cb, pcb)
    # the two-level walk runs the tests the data needs, as the plain version counts them
    assert int(run_k) == int(need_k) == int(run_p) == int(need_p) > 0
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    args = (cs.packed, rays, flag_s, corder, tnear, counts, covbits, TILE)
    kt, pt, kn, pn = (torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4))
    for a, b in zip(tkern.closest(*args, slot_tests=kt, needed_tests=kn),
                    tkern.closest_plain(*args, slot_tests=pt, needed_tests=pn)):
        assert torch.equal(a, b)
    # the kernel runs exactly the slot tests the data needs
    assert int(kt) == int(pt) == int(kn) == int(pn) > 0
    assert (tkern.coverage.launches, tkern.closest.launches) == \
        (launches[0] + 2, launches[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters,tile", [(70, 256), (96, 512)])
def test_coverage_equals_plain_version_on_adversarial_rays(card, n_clusters, tile):
    """The coverage kernel on rays at the slab test's edges (zero and
    1e-13 direction components, origins on faces and inside boxes, grazing
    rays, rays through the pad columns' zero box, dead lanes and a dead
    tile, a word that is part pad and one that is all pad): bit for bit
    its plain version's tnear and covbits, and equal test counts."""
    rays, bounds, nlt = adversarial_coverage_case(n_clusters, tile, "cuda")
    run_k, need_k, run_p, need_p = (torch.zeros(1, dtype=torch.int64, device="cuda")
                                    for _ in range(4))
    tn, cb = tkern.coverage(rays, bounds, nlt, n_clusters, tile, tests_run=run_k,
                            tests_needed=need_k)
    ptn, pcb = tkern.coverage_plain(rays, bounds, nlt, n_clusters, tile, tests_run=run_p,
                                    tests_needed=need_p)
    assert torch.equal(tn, ptn) and torch.equal(cb, pcb)
    assert torch.equal(torch.isinf(tn), torch.isinf(ptn))
    assert (int(run_k) == int(need_k) == int(run_p) == int(need_p)
            > 2 * tile * bounds.shape[1] // 32)
    assert (cb[:2, -1] != 0).any()          # the all-pad word is entered


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["closest", "occluded"])
def test_tracers_over_more_tiles_than_the_order_block(card, kind):
    """A launch over 1,030 tiles (more than the 1,024 threads of the block
    that orders the tiles by count) equals launches over slices of at most
    300 tiles, in every output and in both counters: a tile's results do
    not depend on where the order puts it."""
    verts, idx, o, d, t_min, t_max, flag = _soup_and_rays(25, n=1030 * TILE)
    cs = tcl.build_clusters(verts, idx, "cuda")
    _, rays, flag_s = tcl.prepare(cs, o, d, t_min, t_max, TILE, flag)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    nt = rays.shape[1] // TILE
    assert nt == 1030

    def trace(a, b, tests, needed):
        lanes = slice(a * TILE, b * TILE)
        per_tile = [x[a:b].contiguous() for x in (corder, tnear, counts, covbits)]
        r = rays[:, lanes].contiguous()
        if kind == "closest":
            out = tkern.closest(cs.packed, r, flag_s[lanes].contiguous(), *per_tile, TILE,
                                slot_tests=tests, needed_tests=needed)
            return [x.reshape(x.shape[0], -1) for x in out]
        return [tkern.occluded(cs.packed, r, *per_tile, TILE, slot_tests=tests,
                               needed_tests=needed)]

    counters = [torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4)]
    whole = trace(0, nt, *counters[:2])
    parts = [trace(a, min(a + 300, nt), *counters[2:]) for a in range(0, nt, 300)]
    for w, *p in zip(whole, *parts):
        assert torch.equal(w, torch.cat(p))
    assert int(counters[0]) == int(counters[2]) > 0
    assert int(counters[1]) == int(counters[3]) > 0


@pytest.mark.cuda
def test_gather_packed_exact_on_the_card(card):
    """Bit patterns (NaN, infinities, denormals, int64 words) survive the
    wavefront-compaction gather on the card."""
    from pbrt_tpu_torch.integrate import path as tpath
    r = np.random.RandomState(5)
    n = 999
    f = r.randn(n, 3).astype(np.float32)
    f[:4, 0] = [np.nan, np.inf, -np.inf, 1e-42]
    ints = r.randint(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    arrays = [torch.as_tensor(f, device="cuda"), torch.as_tensor(ints, device="cuda"),
              torch.as_tensor(r.rand(n) < 0.5, device="cuda")]
    order = torch.as_tensor(r.permutation(n)[:700], device="cuda")
    for got, a in zip(tpath._gather_packed(order, arrays), arrays):
        want = a[order]
        if a.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [23, 24])
def test_occluded_equals_plain_version(card, seed):
    """Exact occ, equal slot-test counts (run and needed) on finite and
    infinite windows, 20% dead lanes; the launch is counted once."""
    verts, idx, o, d, t_min, t_max, _ = _soup_and_rays(seed)
    cs = tcl.build_clusters(verts, idx, "cuda")
    _, rays, _ = tcl.prepare(cs, o, d, t_min, t_max, TILE)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    args = (cs.packed, rays, corder, tnear, counts, covbits, TILE)
    kt, pt, kn, pn = (torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4))
    before = tkern.occluded.launches
    occ = tkern.occluded(*args, slot_tests=kt, needed_tests=kn)
    assert tkern.occluded.launches == before + 1
    assert torch.equal(occ, tkern.occluded_plain(*args, slot_tests=pt, needed_tests=pn))
    assert int(kt) == int(pt) > 0 and 0 < int(occ.sum()) < occ.numel()
    assert int(kn) == int(pn) and 0 < int(kn) < int(kt)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [256, 1024])
def test_compaction_probe_equals_plain_version(card, tile):
    mask, val = probes.compact_inputs(tile, "cuda")
    assert int(mask.sum()) > 128
    for a, b in zip(probes.compact(mask, val), probes.compact_plain(mask, val)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1000, 256, 1024])
@pytest.mark.parametrize("p", [1.0, 0.0, 0.7, "graded"])
def test_compaction_probe_on_every_mask(card, tile, p):
    """All lanes set, none set, 70% set and a graded mask in [0, 1) (set
    above 0.5), val 0 and -0.0 among them, at a tile of whole warps and one
    that ends inside a warp: bit for bit the plain version; one launch
    counted."""
    mask, val = probes.compact_inputs(tile, "cuda", seed=9, p=0.5 if p == "graded" else p,
                                      zeros=True)
    if p == "graded":
        mask = torch.rand(mask.shape, generator=torch.Generator().manual_seed(9)).cuda()
    before = probes.compact.launches
    out, slot = probes.compact(mask, val)
    assert probes.compact.launches == before + 1
    pout, pslot = probes.compact_plain(mask, val)
    assert torch.equal(out.view(torch.int32), pout.view(torch.int32))
    assert torch.equal(slot, pslot)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", probes.KINDS)
def test_overhead_probe_equals_plain_version(card, kind):
    args = probes.overhead_inputs(20, "cuda", nt=16)
    assert torch.equal(probes.overhead(kind, *args, probes.TILE),
                       probes.overhead_plain(kind, *args, probes.TILE))


@pytest.mark.cuda
@pytest.mark.parametrize("n5", [1, 5])
@pytest.mark.parametrize("tile", [256, 1024])
def test_overhead_probe_ring_wrap(card, n5, tile):
    """Counts 0, 7, 8, 9 and 64 in one launch (tiles with no round, a
    partial round, one whole round, a round and one cluster, eight
    rounds), so the ring of two cluster buffers wraps across rounds and
    tiles at every phase: every kind bit for bit its plain version, at
    n5 = 1 and 5, with two groups of compute threads (tile 256) and one
    (tile 1,024); one launch counted each."""
    packed, planes, corder, _ = probes.overhead_inputs(0, "cuda", nt=5, tile=tile, n5=n5,
                                                       seed=n5)
    counts = torch.tensor([0, 7, 8, 9, 64], dtype=torch.int32, device="cuda")
    for kind in probes.KINDS:
        before = probes.overhead.launches
        out = probes.overhead(kind, packed, planes, corder, counts, tile)
        assert probes.overhead.launches == before + 1
        plain = probes.overhead_plain(kind, packed, planes, corder, counts, tile)
        assert torch.equal(out.view(torch.int32), plain.view(torch.int32))
        if kind != "empty":
            assert (out[0] == 0).all() and (out[1:] != 0).all()


def _cornell_wavefronts(res=64):
    """The native Cornell box (one cluster) and three wavefronts through
    it: primary rays, a fused bounce (extension lanes, then shadow lanes
    toward the ceiling light) and direct lighting's shadow rays."""
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.integrate import direct, driver
    from pbrt_tpu_torch.geom import scene as tscene
    scene = scenes.cornell_spheres(False, "area", "cuda", tile=TILE)
    cam = scenes.cornell_camera((res, res), "cuda")
    cfg = driver.RenderConfig(width=res, height=res, spp=1,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = driver.lane_ids(cfg, 0, 1, "cuda")
    o, d, _, _ = driver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    n = o.shape[0]
    t_min = torch.full((n,), 1e-4, device="cuda")
    t_max = torch.full((n,), float("inf"), device="cuda")
    hit = tscene.intersect(scene, o, d)
    r = np.random.RandomState(3)
    wi = hit.ns + torch.as_tensor(r.randn(n, 3).astype(np.float32), device="cuda")
    wi = wi / wi.norm(dim=-1, keepdim=True)
    to_l = scene.lights.em_tri_p[0].reshape(-1, 3).mean(0) - hit.p
    dist = to_l.norm(dim=-1)
    dead = ~hit.valid
    bounce = (torch.cat([hit.p + 1e-3 * hit.ng, hit.p + 1e-3 * hit.ng]),
              torch.cat([wi, to_l / dist[:, None]]), torch.cat([t_min, t_min]),
              torch.cat([torch.where(dead, -1.0, float("inf")),
                         torch.where(dead, -1.0, dist * 0.999)]),
              torch.cat([torch.zeros(n, device="cuda"), torch.ones(n, device="cuda")]))
    sent = []
    real = tcl.occluded
    tcl.occluded = lambda cs, *a: (sent.append(a[:4]), real(cs, *a))[1]
    try:
        driver.render_lanes(scene, cam, cfg, direct.make_li(cfg, "one"), pid, sid)
    finally:
        tcl.occluded = real
    return scene.clusters, (o, d, t_min, t_max, None), bounce, sent[0]


@pytest.mark.cuda
@pytest.mark.parametrize("wavefront", ["primary", "fused_bounce", "direct_shadow"])
def test_tracers_on_the_one_cluster_cornell_box(card, wavefront):
    """Coverage, closest hit and any hit on the Cornell box's wavefronts:
    one cluster (C = 1) in a coverage word of 128 columns, all but one of
    them padding. Bit for bit their plain versions, equal test counts."""
    cs, primary, bounce, shadow = _cornell_wavefronts()
    assert cs.n_clusters == 1 and cs.bounds.shape[1] == 128
    o, d, t_min, t_max, flag = {"primary": primary, "fused_bounce": bounce,
                                "direct_shadow": (*shadow, None)}[wavefront]
    _, rays, flag_s = tcl.prepare(cs, o, d, t_min, t_max, TILE, flag)
    n_live = int((rays[7] > rays[6]).sum())
    nlt = torch.tensor([-(-n_live // TILE)], dtype=torch.int32, device="cuda")
    c = [torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4)]
    tn, cb = tkern.coverage(rays, cs.bounds, nlt, 1, TILE, tests_run=c[0], tests_needed=c[1])
    ptn, pcb = tkern.coverage_plain(rays, cs.bounds, nlt, 1, TILE, tests_run=c[2],
                                    tests_needed=c[3])
    assert torch.equal(tn, ptn) and torch.equal(cb, pcb)
    assert int(c[0]) == int(c[1]) == int(c[2]) == int(c[3]) > 0
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    c = [torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4)]
    if wavefront == "direct_shadow":
        args = (cs.packed, rays, corder, tnear, counts, covbits, TILE)
        occ = tkern.occluded(*args, slot_tests=c[0], needed_tests=c[1])
        assert torch.equal(occ, tkern.occluded_plain(*args, slot_tests=c[2],
                                                     needed_tests=c[3]))
        assert 0 < int(occ.sum()) < n_live
    else:
        args = (cs.packed, rays, flag_s, corder, tnear, counts, covbits, TILE)
        for a, b in zip(tkern.closest(*args, slot_tests=c[0], needed_tests=c[1]),
                        tkern.closest_plain(*args, slot_tests=c[2], needed_tests=c[3])):
            assert torch.equal(a, b)
    assert int(c[0]) == int(c[2]) > 0 and int(c[1]) == int(c[3]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("light", ["point", "area", "env"])
def test_cornell_direct_on_the_card_matches_the_cpu(card, light):
    """Config 1's direct lighting at 32×32, 2 spp through the kernels on
    the card against the plain versions on the CPU (the pixel check of
    tests/test_oracle.py)."""
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.integrate import direct, driver
    cfg = driver.RenderConfig(width=32, height=32, spp=2,
                              sampler=smp.SamplerConfig(kind="random", spp=2))
    imgs = [driver.render(scenes.cornell_spheres(False, light, dev, tile=TILE),
                          scenes.cornell_camera((32, 32), dev), cfg,
                          direct.make_li(cfg)).cpu().numpy() for dev in ("cuda", "cpu")]
    diff = np.abs(imgs[0] - imgs[1])
    ok = (diff / np.maximum(np.abs(imgs[1]), 1e-2) < 2e-3).all(-1)
    assert ok.mean() >= 0.995 and abs(imgs[0].mean() - imgs[1].mean()) < 1e-3


def _small_frame(integrator, dev, res=32, spp=2):
    """A config-4 fog frame (volpath) or a config-2 box frame (Whitted)."""
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.integrate import driver, volpath, whitted
    cfg = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
    if integrator == "volpath":
        scene, li = scenes.fog_scene(device=dev, tile=TILE), volpath.make_li(cfg)
    else:
        scene, li = scenes.cornell_spheres(True, "area", dev, tile=TILE), whitted.make_li(cfg)
    cam = scenes.cornell_camera((res, res), dev)
    return scene, lambda: driver.render(scene, cam, cfg, li)


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["volpath", "whitted"])
def test_volpath_and_whitted_launches_and_image_on_the_card(card, integrator):
    """Kernel launches a frame: volpath 6/6/0 (a primary and five fused
    launches); Whitted 5 closest and 5 any hit per light row. The image
    passes the pixel check against the plain versions on the CPU."""
    kernels = (tkern.coverage, tkern.closest, tkern.occluded)
    scene, frame = _small_frame(integrator, "cuda")
    for k in kernels:
        k.launches = 0
    img = frame().cpu().numpy()
    nl = scene.lights.count
    want = (6, 6, 0) if integrator == "volpath" else (5 + 5 * nl, 5, 5 * nl)
    assert tuple(k.launches for k in kernels) == want
    ref = _small_frame(integrator, "cpu")[1]().numpy()
    diff = np.abs(img - ref)
    ok = (diff / np.maximum(np.abs(ref), 1e-2) < 2e-3).all(-1)
    assert np.isfinite(img).all() and img.mean() > 0.1
    assert ok.mean() >= 0.995 and abs(img.mean() - ref.mean()) < 1e-3


@pytest.mark.cuda
def test_fused_volpath_launch_equals_plain_version(card):
    """The first fused launch of a small fog frame (N extension and 2N
    shadow lanes): coverage and closest hit bit for bit their plain
    versions on every tile, equal test counts."""
    sent = []
    real = tcl._trace
    tcl._trace = lambda cs, o, d, t_min, t_max, tile, flag=None: (
        sent.append((o, d, t_min, t_max, flag)), real(cs, o, d, t_min, t_max, tile, flag))[1]
    try:
        scene, frame = _small_frame("volpath", "cuda", res=64)
        frame()
    finally:
        tcl._trace = real
    o, d, t_min, t_max, flag = sent[1]
    n = sent[0][0].shape[0]
    assert o.shape[0] == 3 * n and int(flag.sum()) == 2 * n
    cs = scene.clusters
    _, rays, flag_s = tcl.prepare(cs, o, d, t_min, t_max, TILE, flag)
    n_live = int((rays[7] > rays[6]).sum())
    nlt = torch.tensor([-(-n_live // TILE)], dtype=torch.int32, device="cuda")
    c = [torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4)]
    tn, cb = tkern.coverage(rays, cs.bounds, nlt, cs.n_clusters, TILE, tests_run=c[0],
                            tests_needed=c[1])
    ptn, pcb = tkern.coverage_plain(rays, cs.bounds, nlt, cs.n_clusters, TILE,
                                    tests_run=c[2], tests_needed=c[3])
    assert torch.equal(tn, ptn) and torch.equal(cb, pcb)
    assert int(c[0]) == int(c[1]) == int(c[2]) == int(c[3]) > 0
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    c = [torch.zeros(1, dtype=torch.int64, device="cuda") for _ in range(4)]
    args = (cs.packed, rays, flag_s, corder, tnear, counts, covbits, TILE)
    for a, b in zip(tkern.closest(*args, slot_tests=c[0], needed_tests=c[1]),
                    tkern.closest_plain(*args, slot_tests=c[2], needed_tests=c[3])):
        assert torch.equal(a, b)
    assert int(c[0]) == int(c[2]) > 0 and int(c[1]) == int(c[3]) > 0


def _cornell_train_step(device, res=16, spp=2):
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.diff import demo
    from pbrt_tpu_torch.dist import sharding
    from pbrt_tpu_torch.integrate import driver, path
    scene = scenes.cornell_spheres(device=device, tile=TILE)
    cam = scenes.cornell_camera((res, res), device)
    cfg = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
    step, bad, target = demo.training(scene, cam, cfg, path.make_li(cfg), demo.perturbed,
                                      sharding.make_mesh(1))
    return step, bad, cam, target


@pytest.mark.cuda
def test_training_step_on_the_card_matches_the_cpu(card):
    """One Cornell training step (path, depth 5, 16×16, 2 spp): the
    forward launches coverage and closest hit six times each, the
    backward launches no tracer, and the loss and the kd and emit
    gradients equal the plain versions' on the CPU at rtol 1e-4, atol
    1e-6 (chip_smoke.py's grad_cpu_parity)."""
    kernels = (tkern.coverage, tkern.closest, tkern.occluded)
    got = []
    for dev in ("cuda", "cpu"):
        step, bad, cam, target = _cornell_train_step(dev)
        for k in kernels:
            k.launches = 0
        loss, params, _ = step.forward(bad, cam, target)
        fwd = tuple(k.launches for k in kernels)
        grads = step.backward(loss, params)
        assert tuple(k.launches for k in kernels) == fwd
        if dev == "cuda":
            assert fwd == (6, 6, 0)
        got.append((float(loss.detach()), {k: v.cpu().numpy() for k, v in grads.items()}))
    (lg, gg), (lc, gc) = got
    np.testing.assert_allclose(lg, lc, rtol=1e-4)
    for k in ("kd", "emit"):
        assert np.isfinite(gg[k]).all() and np.abs(gg[k]).max() > 1e-4
        np.testing.assert_allclose(gg[k], gc[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.cuda
def test_splat_scatter_is_deterministic_on_the_card(card):
    """film.add_splats at BDPT's shapes (262,144 values onto 512×512, many
    on a few pixels): two runs on the card give the same image, bit for
    bit (a sorted accumulate, no atomics), allclose to the CPU's."""
    from pbrt_tpu_torch.film import film
    r = np.random.RandomState(9)
    n, res = 1 << 18, 512
    pf = (r.rand(n, 2) * (res + 8) - 4).astype(np.float32)
    pf[: n // 8] = r.randint(0, 4, (n // 8, 2)) + 0.5
    val, on = r.rand(n, 3).astype(np.float32), r.rand(n) < 0.7
    out = []
    for dev in ("cuda", "cuda", "cpu"):
        t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
        out.append(film.add_splats(torch.zeros((res, res, 3), device=dev), t(pf), t(val),
                                   t(on)).cpu())
    assert torch.equal(out[0], out[1])
    np.testing.assert_allclose(out[0].numpy(), out[2].numpy(), rtol=1e-5, atol=1e-5)
    assert float(out[0][:4, :4].sum()) > 1000.0


@pytest.mark.cuda
def test_distribution_build_is_repeatable_on_the_card(card):
    """Distribution1D.build of one long row (MLT's 262,144 bootstrap
    luminances plus one): ten builds on the card give the same cdf bit for
    bit, and the CPU's (prefix_sum: elementwise float64 adds on both)."""
    from pbrt_tpu_torch.core import sampling
    func = np.random.RandomState(11).rand(262145).astype(np.float32)
    cdfs = [sampling.Distribution1D.build(torch.as_tensor(func, device="cuda")).cdf.cpu()
            for _ in range(10)]
    assert all(torch.equal(cdfs[0], c) for c in cdfs[1:])
    assert torch.equal(cdfs[0], sampling.Distribution1D.build(torch.as_tensor(func)).cdf)


@pytest.mark.cuda
def test_sample_le_on_the_card_matches_the_cpu(card):
    """lights.sample_le of all eight kinds (the Cornell box with
    scenes.all_kinds_rows) on the card against the CPU, rtol 1e-4, atol
    1e-5 on 65,536 lanes (the card's transcendentals round differently)."""
    from pbrt_tpu_torch import scenes
    from pbrt_tpu_torch.lights import lights
    r = np.random.RandomState(10)
    n = 1 << 16
    lt, u_pos, u_dir = (r.randint(0, 8, n), r.rand(n, 2).astype(np.float32),
                        r.rand(n, 2).astype(np.float32))
    got = []
    for dev in ("cuda", "cpu"):
        sc = scenes.with_all_light_kinds(scenes.cornell_spheres(False, "area", dev,
                                                                clusters=False))
        t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
        got.append({k: v.cpu() for k, v in lights.sample_le(
            sc.lights, sc, t(lt), t(u_pos), t(u_dir), sc.world_radius).items()})
    for k in got[0]:
        np.testing.assert_allclose(got[0][k].numpy(), got[1][k].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    assert (got[0]["le"].sum(-1) > 0).float().mean() > 0.5
