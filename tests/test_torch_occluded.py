"""The PyTorch port's standalone any-hit query vs the JAX package: the
plain version of the any-hit kernel through geom.cluster.occluded against
the Pallas kernel in interpret mode and against brute force, the exact
t window on the >128-lane beam, the tile's early stop, scene.occluded,
and the wrapper's input checks.

Thresholds follow tests/test_cluster.py: occlusion agreement > 0.995
against interpret mode and brute force (Plücker and Möller–Trumbore may
disagree on a borderline edge hit); exact equality on the beam, where no
ray grazes an edge. The CUDA kernel itself runs only on the card
(chip_smoke.py phase 4b, tests/test_torch_cuda.py)."""
import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.geom import cluster as jcl
from pbrt_tpu.geom import triangle as jtri
from scenes.bunny import mesh_scene
from scenes.cornell import cornell_spheres
from tests.test_geometry import _tri_soa, _random_soup
from tests.test_torch_cluster import _port_tri, _rays, _t
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.geom import cluster as tcl
from pbrt_tpu_torch.geom import scene as tscene
from pbrt_tpu_torch.geom import triangle as ttri
from pbrt_tpu_torch.kernels import cluster_cuda as tkern
from pbrt_tpu_torch.scenes import bench_scene

TILE = int(os.environ.get("PBRT_TPU_TILE", 256))


def _soup(n_tris, seed, size):
    """_random_soup with triangles `size` across, so shadow rays hit often."""
    r = np.random.RandomState(seed)
    centers = r.rand(n_tris, 3) * 10.0
    verts = (centers[:, None] + size * (r.rand(n_tris, 3, 3) - 0.5)).astype(np.float32)
    return verts.reshape(-1, 3), np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)


def test_occluded_matches_pallas_interpret_and_brute():
    """Random soup, random finite windows, 20% dead lanes. Observed:
    1.0 agreement with both on this input (0.995 required)."""
    verts, idx = _soup(600, 51, 2.0)
    jcs = jcl.build_clusters(verts, idx)
    cs = tcl.build_clusters(verts, idx, "cpu")
    o, d, t_min, t_dead = _rays(700, seed=52, dead=0.2)
    r = np.random.RandomState(53)
    t_max = np.where(t_dead < 0, -1.0, 0.5 + r.rand(700) * 6.0).astype(np.float32)
    occ_inf = ttri.occluded_brute(_port_tri(verts, idx),
                                  *_t(o, d, t_min, np.where(t_dead < 0, -1.0, np.inf)
                                      .astype(np.float32))).numpy()
    occ = tcl.occluded(cs, *_t(o, d, t_min, t_max), tile=TILE).numpy()
    pocc = np.asarray(jcl.occluded_pallas(jcs, *(jnp.asarray(x) for x in (o, d, t_min, t_max)),
                                          interpret=True))
    bocc = ttri.occluded_brute(_port_tri(verts, idx), *_t(o, d, t_min, t_max)).numpy()
    jbocc = np.asarray(jtri.occluded_brute(_tri_soa(verts, idx), *(jnp.asarray(x) for x in
                                                                   (o, d, t_min, t_max))))
    np.testing.assert_array_equal(bocc, jbocc)          # the two brute tracers
    for ref in (pocc, bocc):
        assert (occ == ref).mean() > 0.995, (occ != ref).sum()
    assert not occ[t_max < 0].any()
    assert occ.mean() > 0.2 and (occ_inf & ~occ).mean() > 0.1   # the windows cut


def _beam():
    verts, idx = _random_soup(900, seed=11)
    n = 512
    r = np.random.RandomState(4)
    o = np.stack([np.full(n, -5.0), r.rand(n) * 10.0, r.rand(n) * 10.0], 1).astype(np.float32)
    d = np.tile([[1.0, 0.0, 0.0]], (n, 1)) + r.randn(n, 3) * 0.02
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = (5.0 + r.rand(n) * 12.0).astype(np.float32)
    return verts, idx, o, d, t_min, t_max


def test_beam_is_exact_where_the_fused_path_has_its_band():
    """The 512-lane beam of tests/test_cluster.py:116-142 (lanes covering
    the same clusters, early occlusions inside a round): the standalone
    query equals brute force exactly — no missed occlusion (frozen mask)
    and no hit past t_max. The fused closest-hit shadow lanes read lane
    t = 13.3332 (t_max = 13.3322) as occluded: their (t|slot) key clears
    11 mantissa bits."""
    verts, idx, o, d, t_min, t_max = _beam()
    cs = tcl.build_clusters(verts, idx, "cpu")
    occ_ref = ttri.occluded_brute(_port_tri(verts, idx), *_t(o, d, t_min, t_max)).numpy()
    occ = tcl.occluded(cs, *_t(o, d, t_min, t_max), tile=TILE).numpy()
    np.testing.assert_array_equal(occ, occ_ref)
    assert occ_ref.sum() > 20
    dead = _t(*(x[:1] for x in (o, d, t_min, -np.ones(512, np.float32))))
    _, occ_fused = tcl.intersect_occluded(cs, *dead, *_t(o, d, t_min, t_max), tile=TILE)
    band = occ_fused.numpy() & ~occ_ref
    assert band.sum() >= 1, "the case must show the fused path's band"
    occ_key = ttri.occluded_brute(_port_tri(verts, idx),
                                  *_t(o, d, t_min, t_max * (1 + 2.0 ** -11))).numpy()
    assert occ_key[band].all()


def _walls():
    """A 16×16-square wall at x = 0 (512 triangles, 4 clusters) in front
    of a 32×32-square wall at x = 5 (2048 triangles, 16 clusters)."""
    def wall(x, m):
        g = np.linspace(0.0, 10.0, m + 1, dtype=np.float32)
        yy, zz = np.meshgrid(g, g, indexing="ij")
        v = np.stack([np.full(yy.size, x, np.float32), yy.ravel(), zz.ravel()], 1)
        q = (np.arange(m)[:, None] * (m + 1) + np.arange(m)[None, :]).ravel()
        f = np.concatenate([np.stack([q, q + m + 1, q + 1], 1),
                            np.stack([q + 1, q + m + 1, q + m + 2], 1)])
        return v, f
    v0, f0 = wall(0.0, 16)
    v1, f1 = wall(5.0, 32)
    return np.concatenate([v0, v1]), np.concatenate([f0, f1 + len(v0)]).astype(np.int32)


def test_early_stop_and_padding_tile():
    """Tile 0: every lane is occluded by the front wall in the first round
    of three; tile 1: padding lanes only (t_max = -1) with tile 0's
    cluster list. Results equal brute force (the query without any early
    stop), and the slot tests are those of tile 0's first round."""
    verts, idx = _walls()
    cs = tcl.build_clusters(verts, idx, "cpu")
    r = np.random.RandomState(6)
    n = TILE
    o = np.stack([np.full(n, -5.0), 0.3 + r.rand(n) * 9.4, 0.3 + r.rand(n) * 9.4],
                 1).astype(np.float32)
    d = np.tile(np.float32([[1.0, 0.0, 0.0]]), (n, 1))
    t_min, t_max = np.full(n, 1e-4, np.float32), np.full(n, 100.0, np.float32)
    _, rays, _ = tcl.prepare(cs, *_t(o, d, t_min, t_max), TILE)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    assert int(counts[0]) > 2 * tkern.CH             # three rounds to walk
    pad = rays.clone()
    pad[7] = -1.0
    args = (cs.packed, torch.cat([rays, pad], 1), torch.cat([corder, corder]),
            torch.cat([tnear, tnear]), torch.cat([counts, counts]),
            torch.cat([covbits, covbits]), TILE)
    tests = torch.zeros(1, dtype=torch.int64)
    occ = tkern.occluded(*args, slot_tests=tests)
    assert occ[0].all() and not occ[1].any()
    brute = ttri.occluded_brute(_port_tri(verts, idx), *_t(o, d, t_min, t_max))
    assert brute.all()
    first = torch.zeros(1, dtype=torch.int64)
    one_round = (args[0], rays, corder[:, :tkern.CH].contiguous(),
                 tnear[:, :tkern.CH].contiguous(), torch.full_like(counts, tkern.CH),
                 covbits, TILE)
    assert tkern.occluded(*one_round, slot_tests=first).all()
    assert 0 < int(tests) == int(first) <= TILE * tkern.CH * cs.cluster_size


def test_needed_tests_equal_a_per_lane_walk():
    """The needed slot-test count of occluded_plain equals a walk of each
    lane over its tile's cluster positions in order: clusters its covbits
    name, K slots each, up to and including its first hit (slot tests
    evaluated one cluster at a time over all lanes, outside the kernel's
    rounds and lane lists). The run count is larger: it counts K slots
    for every listed (lane, cluster) pair, while the needed count stops
    at the lane's first hit."""
    verts, idx = _soup(600, 61, 2.0)
    cs = tcl.build_clusters(verts, idx, "cpu")
    o, d, t_min, t_dead = _rays(2 * TILE, seed=62, dead=0.2)
    t_max = np.where(t_dead < 0, -1.0,
                     0.5 + np.random.RandomState(63).rand(2 * TILE) * 6.0).astype(np.float32)
    _, rays, _ = tcl.prepare(cs, *_t(o, d, t_min, t_max), TILE)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    run, needed = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    occ = tkern.occluded_plain(cs.packed, rays, corder, tnear, counts, covbits, TILE,
                               slot_tests=run, needed_tests=needed)
    k = cs.cluster_size
    R = rays.view(8, -1, TILE)
    walk = 0
    for t in range(R.shape[1]):
        tmin, tmax = R[6, t], R[7, t]
        ox, oy, oz, dx, dy, dz = (R[i, t][:, None] for i in range(6))
        m = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
        done = ~(tmax > tmin)
        for p in range(int(counts[t])):
            cid = int(corder[t, p])
            enters = ((covbits[t, cid // 32] >> (cid % 32)) & 1).bool() & ~done
            w0, w1, w2, nd, tnum = tkern._slot_test(cs.packed[cid][None], ox, oy, oz,
                                                    dx, dy, dz, *m)
            hm = torch.minimum(torch.minimum(w0 * nd, w1 * nd), w2 * nd)[0]
            tt = (tnum * (1.0 / nd))[0]
            ok = (hm >= 0.0) & (tt > tmin[:, None]) & (tt < tmax[:, None])
            hit = ok.any(-1)
            first = torch.where(ok, torch.arange(k), k).amin(-1)
            walk += int(torch.where(enters, torch.where(hit, first + 1, k), 0).sum())
            done |= enters & hit
        assert torch.equal(done & (tmax > tmin), occ[t])
    assert int(needed) == walk > 0 and int(run) > walk


def test_scene_occluded_active_masks_and_brute_scene():
    scene = bench_scene(1, "cpu", tile=TILE)
    r = np.random.RandomState(7)
    n = 600
    o = torch.as_tensor(r.randn(n, 3).astype(np.float32) * 0.5
                        + scene.world_center.numpy())
    d = torch.as_tensor(r.randn(n, 3).astype(np.float32))
    d = d / d.norm(dim=-1, keepdim=True)
    t_max = torch.as_tensor(r.rand(n).astype(np.float32) * 3.0 * scene.world_radius)
    active = torch.as_tensor(r.rand(n) < 0.7)
    occ = tscene.occluded(scene, o, d, t_max=t_max, active=active)
    brute = dataclasses.replace(scene, clusters=None)
    occ_b = tscene.occluded(brute, o, d, t_max=t_max, active=active)
    assert not occ[~active].any() and not occ_b[~active].any()
    assert (occ == occ_b).float().mean() > 0.995
    assert 0.05 < occ[active].float().mean() < 0.95
    # defaults: t in (RAY_EPS, INF), every lane live; a scalar t_max broadcasts
    ref = ttri.occluded_brute(scene.tri, o, d, torch.full((n,), 1e-4),
                              torch.full((n,), float("inf")))
    assert (tscene.occluded(scene, o, d) == ref).float().mean() > 0.995
    assert torch.equal(tscene.occluded(brute, o, d, t_max=2.0),
                       tscene.occluded(brute, o, d, t_max=torch.full((n,), 2.0)))


def test_bridge_refuses_quadrics():
    tree = scene_tree(mesh_scene(subdivisions=1, use_bvh=True))
    assert tree["quad_count"] == 0 and tree["instance_count"] == 0
    js = cornell_spheres()
    assert js.quad.kind.shape[0] > 0
    with pytest.raises(NotImplementedError):
        bridge.scene_from_numpy(dict(tree, quad_count=int(js.quad.kind.shape[0])), "cpu")


def test_occluded_wrapper_checks_inputs_and_counts_only_kernel_launches():
    verts, idx = _random_soup(50, seed=1)
    cs = tcl.build_clusters(verts, idx, "cpu")
    o, d, t_min, t_max = _t(*_rays(TILE, seed=2))
    _, rays, _ = tcl.prepare(cs, o, d, t_min, t_max, TILE)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    before = tkern.occluded.launches
    occ = tkern.occluded(cs.packed, rays, corder, tnear, counts, covbits, TILE)
    assert occ.dtype == torch.bool and occ.shape == (1, TILE)
    assert tkern.occluded.launches == before
    with pytest.raises(TypeError):
        tkern.occluded(cs.packed, rays.double(), corder, tnear, counts, covbits, TILE)
    with pytest.raises(TypeError):
        tkern.occluded(cs.packed, rays, corder.long(), tnear, counts, covbits, TILE)
    with pytest.raises(ValueError):
        tkern.occluded(cs.packed, rays, corder[:, :-1], tnear, counts, covbits, TILE)
    with pytest.raises(ValueError):
        tkern.occluded(cs.packed, rays, corder, tnear, counts[:0], covbits, TILE)
    with pytest.raises(ValueError):
        tkern.occluded(cs.packed, rays.t().contiguous().t(), corder, tnear, counts,
                       covbits, TILE)
    with pytest.raises(ValueError):
        tkern.occluded(cs.packed, rays, corder, tnear, counts, covbits, 100)
    with pytest.raises(TypeError):
        tkern.occluded(cs.packed, rays, corder, tnear, counts, covbits, TILE,
                       slot_tests=torch.zeros(1, dtype=torch.int32))
