"""The tracers' pair semantics: a round tests exactly the (lane, cluster)
pairs it lists, not every slot of the round for every joining lane as the
TPU kernels do.

- closest_plain's run count equals its needed count, and both equal a
  walk of each lane over its tile's rounds (pairs decided from the lane's
  best t at the start of the round), which also gives the same slots;
- a plain run whose tiles are cut into blocks that stop on their own
  equals the same run with the early stop switched off, lane for lane;
- the lanes whose results differ from the JAX package's Pallas kernels in
  interpret mode, counted and bounded on the cases of
  tests/test_torch_cluster.py and tests/test_torch_occluded.py. Skipping
  a pair can only drop a hit in a cluster whose slab test says the lane
  misses it, or whose entry t lies past the lane's best t: a numerical
  edge. The bounds are the counts observed on this CPU (printed)."""
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.geom import cluster as jcl
from tests.test_geometry import _random_soup
from tests.test_torch_cluster import _rays, _t
from tests.test_torch_occluded import _beam, _soup

from pbrt_tpu_torch.geom import cluster as tcl
from pbrt_tpu_torch.kernels import cluster_cuda as tkern

TILE = int(os.environ.get("PBRT_TPU_TILE", 256))


def _fused_rays(cs, seed):
    """Extension lanes (infinite windows) and shadow lanes (finite, flag 1),
    20% dead, sorted into tiles as the fused launch takes them."""
    o, d, t_min, t_max = _rays(TILE, seed=seed, dead=0.2)
    os_, ds, tmin_s, tmax_s = _rays(TILE, seed=seed + 1, dead=0.2, tmax=6.0)
    flag = torch.cat([torch.zeros(TILE), torch.ones(TILE)])
    _, rays, flag_s = tcl.prepare(cs, *_t(np.concatenate([o, os_]), np.concatenate([d, ds]),
                                          np.concatenate([t_min, tmin_s]),
                                          np.concatenate([t_max, tmax_s])), TILE, flag)
    return rays, flag_s


def _walk_closest(cs, rays, flag, corder, tnear, counts, covbits):
    """Each lane on its own: in each round, the pairs of clusters it enters
    whose entry t is within its best t at the start of the round, K slot
    tests each; the round's least (t|slot) key replaces the best t if it
    is smaller (shadow lanes then drop it to -1). Returns (slot (nt, TILE),
    slot tests)."""
    k = cs.cluster_size
    R = rays.view(8, -1, TILE)
    nt = R.shape[1]
    slots = torch.full((nt, TILE), -1, dtype=torch.int32)
    tests = 0
    for t in range(nt):
        tmin = torch.clamp(R[6, t], -3e37, 3e37)
        tbest = torch.clamp(R[7, t], -3e37, 3e37)
        ah = flag.view(nt, TILE)[t] > 0
        ox, oy, oz, dx, dy, dz = (R[i, t][:, None] for i in range(6))
        m = (oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx)
        count = int(counts[t])
        for r in range(-(-count // tkern.CH)):
            start = tbest.clone()
            kmin = torch.full((TILE,), tkern._INT_MAX, dtype=torch.int32)
            for j in range(tkern.CH):
                p = r * tkern.CH + j
                if p >= count:
                    break
                cid = int(corder[t, p])
                pair = ((covbits[t, cid // 32] >> (cid % 32)) & 1).bool() & (start >= tnear[t, p])
                tests += k * int(pair.sum())
                w0, w1, w2, nd, tnum = tkern._slot_test(cs.packed[cid][None], ox, oy, oz,
                                                        dx, dy, dz, *m)
                hm = torch.minimum(torch.minimum(w0 * nd, w1 * nd), w2 * nd)[0]
                tt = (tnum * (1.0 / nd))[0]
                ok = (hm >= 0.0) & (tt > tmin[:, None]) & pair[:, None]
                key = torch.where(ok, (tt.view(torch.int32) & ~tkern.SLOT_MASK)
                                  | (j * k + torch.arange(k, dtype=torch.int32)), tkern._INT_MAX)
                kmin = torch.minimum(kmin, key.amin(-1))
            tj = (kmin & ~tkern.SLOT_MASK).view(torch.float32)
            upd = tj < start
            s = (kmin & tkern.SLOT_MASK).to(torch.int64)
            cids = corder[t, torch.clamp(r * tkern.CH + s // k, max=corder.shape[1] - 1)]
            slots[t] = torch.where(upd, (cids * k + s % k).to(torch.int32), slots[t])
            tbest = torch.where(upd, torch.where(ah, -1.0, tj), start)
    return slots, tests


def test_closest_counts_equal_a_per_lane_walk():
    verts, idx = _soup(600, 71, 2.0)
    cs = tcl.build_clusters(verts, idx, "cpu")
    rays, flag = _fused_rays(cs, 72)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    run, needed = torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64)
    _, slot, _ = tkern.closest_plain(cs.packed, rays, flag, corder, tnear, counts, covbits,
                                     TILE, slot_tests=run, needed_tests=needed)
    walk_slot, walk = _walk_closest(cs, rays, flag, corder, tnear, counts, covbits)
    assert int(run) == int(needed) == walk > 0
    assert torch.equal(slot, walk_slot)
    assert (slot >= 0).float().mean() > 0.2


@pytest.mark.parametrize("block", [32, 64, 128])
def test_split_tile_equals_the_run_without_early_stop(block):
    """Blocks of `block` lanes that stop on their own against whole tiles
    that never stop: the same t, slot and barycentrics for every lane, and
    the same slot-test counts (the stop drops no pair on this input)."""
    verts, idx = _soup(600, 81, 2.0)
    cs = tcl.build_clusters(verts, idx, "cpu")
    rays, flag = _fused_rays(cs, 82)
    corder, tnear, counts, covbits = tcl.tile_cluster_order(cs, rays, TILE)
    args = (cs.packed, rays, flag, corder, tnear, counts, covbits, TILE)
    c_split, c_full = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    split = tkern.closest_plain(*args, slot_tests=c_split, block=block)
    full = tkern.closest_plain(*args, slot_tests=c_full, block=TILE, prune=False)
    for a, b in zip(split, full):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(c_split) == int(c_full) > 0
    assert (split[1] >= 0).any()


def _differ_closest(port, ref):
    """Lanes whose hit flag differs, or whose triangle differs where both hit."""
    h, ti = (np.asarray(x) for x in port)
    rh, ri = (np.asarray(x) for x in ref)
    return int((h != rh).sum() + ((h & rh) & (ti != ri)).sum())


def _case(name):
    """(port's results, the JAX kernel's in interpret mode) as lists of
    (kind, port array(s), JAX array(s))."""
    if name == "closest":     # tests/test_torch_cluster.py, soup 21, rays 22
        verts, idx = _random_soup(600, seed=21)
        o, d, t_min, t_max = _rays(700, seed=22)
        cs, jcs = tcl.build_clusters(verts, idx, "cpu"), jcl.build_clusters(verts, idx)
        h, _, ti, _, _ = tcl.intersect(cs, *_t(o, d, t_min, t_max), tile=TILE)
        jh, _, jti, _, _ = jcl.intersect_pallas(jcs, *(jnp.asarray(x) for x in
                                                       (o, d, t_min, t_max)), interpret=True)
        return [("closest", (h, ti), (jh, jti))]
    if name == "fused":       # soup 31, rays 32 and shadow rays 33
        verts, idx = _random_soup(600, seed=31)
        o, d, t_min, t_max = _rays(500, seed=32, dead=0.2)
        os_, ds, tmin_s, tmax_s = _rays(400, seed=33, dead=0.2, tmax=6.0)
        cs, jcs = tcl.build_clusters(verts, idx, "cpu"), jcl.build_clusters(verts, idx)
        a = (o, d, t_min, t_max, os_, ds, tmin_s, tmax_s)
        (h, _, ti, _, _), occ = tcl.intersect_occluded(cs, *_t(*a), tile=TILE)
        (jh, _, jti, _, _), jocc = jcl.intersect_occluded_pallas(
            jcs, *(jnp.asarray(x) for x in a), interpret=True)
        return [("closest", (h, ti), (jh, jti)), ("occluded", occ, jocc)]
    if name == "occluded":    # tests/test_torch_occluded.py, soup 51, windows 53
        verts, idx = _soup(600, 51, 2.0)
        o, d, t_min, t_dead = _rays(700, seed=52, dead=0.2)
        t_max = np.where(t_dead < 0, -1.0, 0.5 + np.random.RandomState(53).rand(700) * 6.0
                         ).astype(np.float32)
        cs, jcs = tcl.build_clusters(verts, idx, "cpu"), jcl.build_clusters(verts, idx)
        a = (o, d, t_min, t_max)
        return [("occluded", tcl.occluded(cs, *_t(*a), tile=TILE),
                 jcl.occluded_pallas(jcs, *(jnp.asarray(x) for x in a), interpret=True))]
    # the 512-lane beam, standalone any hit and as shadow lanes of the fused launch
    verts, idx, o, d, t_min, t_max = _beam()
    cs, jcs = tcl.build_clusters(verts, idx, "cpu"), jcl.build_clusters(verts, idx)
    a = (o, d, t_min, t_max)
    dead = tuple(x[:1] for x in (o, d, t_min, -np.ones(512, np.float32)))
    _, occ_f = tcl.intersect_occluded(cs, *_t(*dead), *_t(*a), tile=TILE)
    _, jocc_f = jcl.intersect_occluded_pallas(jcs, *(jnp.asarray(x) for x in dead + a),
                                              interpret=True)
    return [("occluded", tcl.occluded(cs, *_t(*a), tile=TILE),
             jcl.occluded_pallas(jcs, *(jnp.asarray(x) for x in a), interpret=True)),
            ("occluded_fused", occ_f, jocc_f)]


# lanes observed to differ from the JAX kernels on this CPU, per result
OBSERVED = {"closest": [0], "fused": [0, 0], "occluded": [0], "beam": [0, 0]}


@pytest.mark.parametrize("name", list(OBSERVED))
def test_lanes_that_differ_from_the_jax_kernels(name):
    differ = []
    for kind, port, ref in _case(name):
        if kind == "closest":
            differ.append(_differ_closest(port, ref))
        else:
            differ.append(int((np.asarray(port) != np.asarray(ref)).sum()))
    print(f"{name}: lanes that differ from the JAX kernel in interpret mode: {differ}")
    assert all(n <= bound for n, bound in zip(differ, OBSERVED[name])), differ
