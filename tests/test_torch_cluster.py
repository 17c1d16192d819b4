"""PyTorch port's tile×cluster tracer vs the JAX package: cluster build,
the coverage and closest-hit plain versions against the Pallas kernels in
interpret mode, and both against the brute-force tracers.

Thresholds follow tests/test_cluster.py: Plücker and Möller–Trumbore may
disagree on borderline edge hits, so hit agreement > 0.995, triangle id
> 0.99 where both hit, t within rtol 1e-3, barycentrics within atol 2e-3,
dead lanes unhit. The CUDA kernels themselves run only on the card
(chip_smoke.py phase 4, and tests/test_torch_cuda.py)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.geom import cluster as jcl
from pbrt_tpu.geom import triangle as jtri
from pbrt_tpu.kernels import cluster_pallas as jkp
from scenes.bunny import mesh_scene
from tests.test_geometry import _tri_soa, _random_soup

from pbrt_tpu_torch.geom import cluster as tcl
from pbrt_tpu_torch.geom import triangle as ttri
from pbrt_tpu_torch.geom.types import triangles_from_numpy
from pbrt_tpu_torch.kernels import cluster_cuda as tkern

TILE = int(os.environ.get("PBRT_TPU_TILE", 256))


def _rays(n, seed, spread=10.0, dead=0.0, tmax=np.inf):
    r = np.random.RandomState(seed)
    o = (r.rand(n, 3) * spread).astype(np.float32)
    d = r.randn(n, 3)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_min = np.full(n, 1e-4, np.float32)
    t_max = np.where(r.rand(n) < dead, -1.0, tmax).astype(np.float32)
    return o, d, t_min, t_max


def _t(*a):
    return [torch.as_tensor(x) for x in a]


def _port_tri(verts, idx):
    t = len(idx)
    return triangles_from_numpy(verts, idx, np.zeros_like(verts),
                                np.zeros((len(verts), 2), np.float32), np.zeros(t, bool),
                                np.zeros(t), np.full(t, -1), "cpu")


def _bounds_from_cov(cov):
    cov = np.asarray(cov)
    return np.stack([cov[ax, 2 * ax + h] for ax in range(3) for h in (0, 1)])


@pytest.mark.parametrize("case", ["bench_mesh", "soup_k32"])
def test_build_clusters_matches_jax(case):
    if case == "bench_mesh":
        js = mesh_scene(subdivisions=2, use_bvh=True)
        verts, idx, k, jcs = (np.asarray(js.tri.positions), np.asarray(js.tri.indices),
                              128, js.clusters)
    else:
        verts, idx = _random_soup(300, seed=5)
        k = 32
        jcs = jcl.build_clusters(verts, idx, k=k)
    arrs = tcl.build_clusters_np(verts, idx, k=k)
    np.testing.assert_array_equal(arrs["packed"], np.asarray(jcs.packed))
    np.testing.assert_array_equal(arrs["c_tri_id"], np.asarray(jcs.c_tri_id))
    np.testing.assert_array_equal(arrs["bounds"], _bounds_from_cov(jcs.cov_mxu))
    np.testing.assert_array_equal(arrs["world_min"], np.asarray(jcs.world_min))
    np.testing.assert_array_equal(arrs["world_max"], np.asarray(jcs.world_max))


def test_coverage_plain_matches_pallas_interpret():
    verts, idx = _random_soup(600, seed=21)
    jcs = jcl.build_clusters(verts, idx)
    cs = tcl.build_clusters(verts, idx, "cpu")
    o, d, t_min, t_max = _rays(1500, seed=22, dead=0.2)
    _, rays, _ = tcl.prepare(cs, *_t(o, d, t_min, t_max), TILE)
    # whole grid steps of TPB tiles for the Pallas kernel: pad with dead tiles
    nt = -(-rays.shape[1] // (TILE * jkp.TPB)) * jkp.TPB
    pad = torch.zeros((8, nt * TILE - rays.shape[1]))
    pad[7] = -1.0
    rays = torch.cat([rays, pad], 1).contiguous()
    n_live = int((rays[7] > rays[6]).sum())
    nlt = -(-n_live // TILE)
    tn, cb = tkern.coverage(rays, cs.bounds, torch.tensor([nlt], dtype=torch.int32),
                            cs.n_clusters, TILE)
    planes = tuple(jnp.asarray(rays[i].reshape(nt, 1, TILE).numpy()) for i in range(8))
    jtn, jcb = jkp.coverage_tiles(planes, jcs.cov_mxu, cs.n_clusters,
                                  n_live_tiles=jnp.int32(nlt), interpret=True)
    jtn, jcb = np.asarray(jtn), np.asarray(jcb)
    tn, cb = tn.numpy(), cb.numpy()
    np.testing.assert_array_equal(np.isfinite(tn), np.isfinite(jtn))
    fin = np.isfinite(tn)
    np.testing.assert_allclose(tn[fin], jtn[fin], rtol=1e-5)
    # bf16x3 products in interpret mode may flip a slab test at a box face
    bits = np.unpackbits(cb.view(np.uint8))
    jbits = np.unpackbits(jcb.view(np.uint8))
    assert (bits == jbits).mean() >= 0.999, (bits != jbits).sum()


def _closest_case():
    verts, idx = _random_soup(600, seed=21)
    o, d, t_min, t_max = _rays(700, seed=22)
    return verts, idx, o, d, t_min, t_max


def test_closest_matches_pallas_interpret_and_brute():
    verts, idx, o, d, t_min, t_max = _closest_case()
    jcs = jcl.build_clusters(verts, idx)
    cs = tcl.build_clusters(verts, idx, "cpu")
    h, t, ti, b1, b2 = (x.numpy() for x in
                        tcl.intersect(cs, *_t(o, d, t_min, t_max), tile=TILE))
    ph, pt, pi, pb1, pb2 = (np.asarray(x) for x in jcl.intersect_pallas(
        jcs, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min), jnp.asarray(t_max),
        interpret=True))
    bh, bt, bi, bb1, bb2 = (x.numpy() for x in
                            ttri.intersect_brute(_port_tri(verts, idx), *_t(o, d, t_min, t_max)))
    jbh = np.asarray(jtri.intersect_brute(_tri_soa(verts, idx), jnp.asarray(o),
                                          jnp.asarray(d), jnp.asarray(t_min),
                                          jnp.asarray(t_max))[0])
    np.testing.assert_array_equal(bh, jbh)          # the two brute tracers
    for rh, rt, ri, rb1, rb2 in ((ph, pt, pi, pb1, pb2), (bh, bt, bi, bb1, bb2)):
        assert (h == rh).mean() > 0.995
        both = h & rh
        assert (ti[both] == ri[both]).mean() > 0.99
        m = both & (ti == ri)
        np.testing.assert_allclose(t[m], rt[m], rtol=1e-3)
        np.testing.assert_allclose(b1[m], rb1[m], atol=2e-3)
        np.testing.assert_allclose(b2[m], rb2[m], atol=2e-3)
    assert np.isinf(t[~h]).all()


def test_fused_closest_anyhit_matches_pallas_interpret_and_brute():
    verts, idx = _random_soup(600, seed=31)
    jcs = jcl.build_clusters(verts, idx)
    cs = tcl.build_clusters(verts, idx, "cpu")
    o, d, t_min, t_max = _rays(500, seed=32, dead=0.2)
    os_, ds, tmin_s, tmax_s = _rays(400, seed=33, dead=0.2, tmax=6.0)
    (h, t, ti, _, _), occ = tcl.intersect_occluded(
        cs, *_t(o, d, t_min, t_max, os_, ds, tmin_s, tmax_s), tile=TILE)
    h, t, ti, occ = h.numpy(), t.numpy(), ti.numpy(), occ.numpy()
    (ph, pt, pi, _, _), pocc = jcl.intersect_occluded_pallas(
        jcs, *(jnp.asarray(x) for x in (o, d, t_min, t_max, os_, ds, tmin_s, tmax_s)),
        interpret=True)
    tri = _port_tri(verts, idx)
    bh, bt, bi, _, _ = (x.numpy() for x in ttri.intersect_brute(tri, *_t(o, d, t_min, t_max)))
    bocc = ttri.occluded_brute(tri, *_t(os_, ds, tmin_s, tmax_s)).numpy()
    # vs the Pallas kernel in interpret mode, t within 2e-3: its bf16x3
    # products drop the lo·lo terms (~2^-16 relative), and t = (k − n·o)/(n·d)
    # cancels in the numerator for far origins; on this input it is 1.6e-3
    # from brute force, the port 3e-6
    for rh, rt, ri, rocc, rtol in ((np.asarray(ph), np.asarray(pt), np.asarray(pi),
                                    np.asarray(pocc), 2e-3), (bh, bt, bi, bocc, 1e-3)):
        assert (h == rh).mean() > 0.995
        both = h & rh
        assert (ti[both] == ri[both]).mean() > 0.99
        m = both & (ti == ri)
        np.testing.assert_allclose(t[m], rt[m], rtol=rtol)
        assert (occ == rocc).mean() > 0.995
    assert not h[t_max < 0].any()
    assert not occ[tmax_s < 0].any()


def test_anyhit_beam_wider_than_a_block():
    """A coherent beam of 512 shadow lanes covering the same clusters,
    with finite windows so early occlusions happen (the r5 mask-freeze
    regression of tests/test_cluster.py:116-142): no occlusion is missed.
    Shadow lanes in the fused closest-hit launch compare the (t|slot)
    key's t, whose 11 low mantissa bits are cleared, with t_max — so a hit
    up to 2^-12 relative beyond t_max may count, as in the reference's
    fused kernel; such lanes may read occluded, no other may."""
    verts, idx = _random_soup(900, seed=11)
    cs = tcl.build_clusters(verts, idx, "cpu")
    n = 512
    r = np.random.RandomState(4)
    o = np.stack([np.full(n, -5.0), r.rand(n) * 10.0, r.rand(n) * 10.0], 1).astype(np.float32)
    d = np.tile([[1.0, 0.0, 0.0]], (n, 1)) + r.randn(n, 3) * 0.02
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = (5.0 + r.rand(n) * 12.0).astype(np.float32)
    occ_ref = ttri.occluded_brute(_port_tri(verts, idx), *_t(o, d, t_min, t_max)).numpy()
    jocc = np.asarray(jtri.occluded_brute(_tri_soa(verts, idx), jnp.asarray(o),
                                          jnp.asarray(d), jnp.asarray(t_min),
                                          jnp.asarray(t_max)))
    np.testing.assert_array_equal(occ_ref, jocc)
    occ_key = ttri.occluded_brute(_port_tri(verts, idx),
                                  *_t(o, d, t_min, t_max * (1 + 2.0 ** -11))).numpy()
    # one dead extension lane; the beam rides the fused launch as shadow lanes
    dead = _t(*(x[:1] for x in (o, d, t_min, -np.ones(n, np.float32))))
    _, occ = tcl.intersect_occluded(cs, *dead, *_t(o, d, t_min, t_max), tile=TILE)
    occ = occ.numpy()
    assert occ[occ_ref].all(), "missed occlusions"
    assert not occ[~occ_key].any()
    assert occ_ref.sum() > 20


def test_closest_returns_global_slot():
    """slot = cluster_id·K + lane (not the cluster's rank in the tile's
    entry-t order): c_tri_id.flat[slot] is the brute-force triangle."""
    verts, idx = _random_soup(400, seed=41)
    cs = tcl.build_clusters(verts, idx, "cpu", k=32)
    # rays from outside the soup, so clusters are entered at distinct t
    r = np.random.RandomState(42)
    tgt = r.rand(TILE, 3) * 10.0
    o = tgt + np.array([-30.0, 2.0, 3.0]) + r.randn(TILE, 3)
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    o, d, t_min, t_max = _t(o.astype(np.float32), d.astype(np.float32),
                            np.full(TILE, 1e-4, np.float32),
                            np.full(TILE, np.inf, np.float32))
    order, rays, _ = tcl.prepare(cs, o, d, t_min, t_max, TILE)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    t, slot, bary = tkern.closest(cs.packed, rays, None, corder, tnear, counts, covbits, TILE)
    slot = slot.reshape(-1)[:len(order)]
    hit = slot >= 0
    cid = slot[hit] // cs.cluster_size
    rank = torch.stack([(corder[i // TILE] == c).nonzero()[0, 0]
                        for i, c in zip(hit.nonzero()[:, 0].tolist(), cid.tolist())])
    assert (rank != cid).any(), "case must separate cluster id from rank"
    bh, _, bi, _, _ = ttri.intersect_brute(_port_tri(verts, idx), o[order], d[order],
                                           t_min[order], t_max[order])
    tid = cs.c_tri_id.reshape(-1)[slot[hit].long()]
    assert (hit == bh).float().mean() > 0.995
    assert (tid == bi[hit]).float().mean() > 0.99


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    verts, idx = _random_soup(50, seed=1)
    cs = tcl.build_clusters(verts, idx, "cpu")
    o, d, t_min, t_max = _t(*_rays(TILE, seed=2))
    _, rays, _ = tcl.prepare(cs, o, d, t_min, t_max, TILE)
    nlt = torch.tensor([1], dtype=torch.int32)
    before = (tkern.coverage.launches, tkern.closest.launches)
    tkern.coverage(rays, cs.bounds, nlt, cs.n_clusters, TILE)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    tkern.closest(cs.packed, rays, None, corder, tnear, counts, covbits, TILE)
    assert (tkern.coverage.launches, tkern.closest.launches) == before
    with pytest.raises(TypeError):
        tkern.coverage(rays.double(), cs.bounds, nlt, cs.n_clusters, TILE)
    with pytest.raises(ValueError):
        tkern.coverage(rays[:, :-1], cs.bounds, nlt, cs.n_clusters, TILE)
    with pytest.raises(ValueError):
        tkern.closest(cs.packed, rays, None, corder[:, :-1], tnear, counts, covbits, TILE)
    with pytest.raises(TypeError):
        tkern.closest(cs.packed, rays, None, corder.long(), tnear, counts, covbits, TILE)
    with pytest.raises(ValueError):
        tkern.closest(cs.packed, rays.t().contiguous().t(), None, corder, tnear, counts,
                      covbits, TILE)
