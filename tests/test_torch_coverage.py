"""The coverage kernel's two-level walk, held on the CPU through its plain
version: a lane is tested against each 32-column word's box first, and
against the word's columns only when it enters the box.

- The walk is exact: on inputs at the slab test's edges (adversarial_
  coverage_case in tests/test_torch_cuda.py) no covbit is set outside an
  entered word box, and the plain version with its counters equals the
  flat version bit for bit.
- The counters: run = needed = CPAD/32 box tests for every lane of a live
  tile plus 32 for every (lane, word) whose box the lane enters, against
  an independent numpy count from word boxes built here.
- The bench scene's primary wavefront (128×128) enters no column outside
  an entered word box, and the walk needs under half the flat tests.
- Against coverage_tiles in interpret mode, at the tolerance of
  tests/test_torch_cluster.py (tnear rtol 1e-5, same finite columns,
  bit agreement >= 0.999), with the reference's f32 products
  (PRECISION "highest"): its default bf16x3 products drop the lo·lo terms,
  which at inv = 1e12 (direction components of 1e-13) or an origin on a
  face move t by far more than 1e-5. Pad columns are not compared: the
  reference zeroes their features (the test becomes 0 ∈ [tmin, tmax]), the
  port tests the zero box at the origin; no caller reads pad bits, as
  their tnear is INF.
The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 4)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pbrt_tpu.kernels import cluster_pallas as jkp
from tests.test_torch_cuda import adversarial_coverage_case

from pbrt_tpu_torch.core import samplers as smp
from pbrt_tpu_torch.geom import cluster as tcl
from pbrt_tpu_torch.integrate import driver
from pbrt_tpu_torch.kernels import cluster_cuda as tkern
from pbrt_tpu_torch.scenes import bench_camera, bench_scene

CASES = [(70, 256), (96, 512)]   # (n_clusters, tile): pad inside a word; a whole pad word


def _np_word_entries(rays, bounds, n_live_tiles, tile):
    """(live tiles, tile, CPAD/32) bool: the lane enters the word's box.
    Boxes and slab test in numpy float32, written apart from the port."""
    b = bounds.numpy().reshape(3, 2, -1, 32)
    glo = np.minimum(b[:, 0], b[:, 1]).min(-1)            # (3, words)
    ghi = np.maximum(b[:, 0], b[:, 1]).max(-1)
    r = rays.numpy().reshape(8, -1, tile)[:, :n_live_tiles, :, None]
    f = np.float32
    tn = np.clip(r[6], f(-3e37), f(3e37))
    tf = np.clip(r[7], f(-3e37), f(3e37))
    for ax in range(3):
        d = r[3 + ax]
        d = np.where(np.abs(d) < f(1e-12), np.where(d < 0, f(-1e-12), f(1e-12)), d)
        inv = f(1.0) / d
        noi = -r[ax] * inv
        lo = glo[ax] * inv + noi
        hi = ghi[ax] * inv + noi
        tn = np.maximum(tn, np.minimum(lo, hi))
        tf = np.minimum(tf, np.maximum(lo, hi) * f(1.0001))
    return tn <= tf


def _counted(rays, bounds, nlt, n_clusters, tile):
    run, needed = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    tn, cb = tkern.coverage_plain(rays, bounds, nlt, n_clusters, tile,
                                  tests_run=run, tests_needed=needed)
    return tn, cb, int(run), int(needed)


def _assert_superset(cb, entered, nlt):
    """Every nonzero covbits word of a live tile lies in an entered word
    box; dead tiles are all zero."""
    nonzero = cb[:nlt].numpy().transpose(0, 2, 1) != 0    # (live, tile, words)
    assert not (nonzero & ~entered).any()
    assert not cb[nlt:].any()


@pytest.mark.parametrize("n_clusters,tile", CASES)
def test_word_box_walk_is_exact_on_adversarial_rays(n_clusters, tile):
    rays, bounds, nlt = adversarial_coverage_case(n_clusters, tile, "cpu")
    tn, cb = tkern.coverage_plain(rays, bounds, nlt, n_clusters, tile)
    tn_c, cb_c, run, needed = _counted(rays, bounds, nlt, n_clusters, tile)
    assert torch.equal(tn.view(torch.int32), tn_c.view(torch.int32))
    assert torch.equal(cb, cb_c)
    entered = _np_word_entries(rays, bounds, 2, tile)
    _assert_superset(cb, entered, 2)
    # the case reaches the edges it is meant to: a whole pad word entered
    # (rays through the origin), words entered without a column, dead tile
    words = cb.shape[1]
    assert (cb[:2, words - 1] != 0).any()
    assert (entered & (cb[:2].numpy().transpose(0, 2, 1) == 0)).any()
    assert torch.isinf(tn[2]).all() and torch.isinf(tn[:, n_clusters:]).all()
    assert run == needed < 2 * tile * bounds.shape[1]


@pytest.mark.parametrize("n_clusters,tile", CASES)
def test_needed_count_equals_numpy_word_box_count(n_clusters, tile):
    rays, bounds, nlt = adversarial_coverage_case(n_clusters, tile, "cpu")
    _, _, run, needed = _counted(rays, bounds, nlt, n_clusters, tile)
    entered = _np_word_entries(rays, bounds, 2, tile)
    want = 2 * tile * entered.shape[-1] + 32 * int(entered.sum())
    assert needed == run == want
    # the wrapper on a CPU tensor passes its counters on
    run_w, needed_w = (torch.zeros(1, dtype=torch.int64) for _ in range(2))
    launches = tkern.coverage.launches
    tkern.coverage(rays, bounds, nlt, n_clusters, tile, tests_run=run_w,
                   tests_needed=needed_w)
    assert int(run_w) == int(needed_w) == want
    assert tkern.coverage.launches == launches
    with pytest.raises(TypeError):
        tkern.coverage(rays, bounds, nlt, n_clusters, tile, tests_run=run_w.int())
    with pytest.raises(ValueError):
        tkern.coverage(rays, bounds, nlt, n_clusters, tile,
                       tests_needed=torch.zeros(2, dtype=torch.int64))


@pytest.mark.parametrize("n_clusters,tile", CASES)
def test_coverage_matches_pallas_interpret_on_adversarial_rays(monkeypatch, n_clusters,
                                                                tile):
    monkeypatch.setattr(jkp, "PRECISION", "highest")
    rays, bounds, nlt = adversarial_coverage_case(n_clusters, tile, "cpu")
    tn, cb, _, _ = _counted(rays, bounds, nlt, n_clusters, tile)
    nt, cpad = 3, bounds.shape[1]
    ntp = -(-nt // jkp.TPB) * jkp.TPB          # whole grid steps: pad with dead tiles
    pad = torch.zeros((8, (ntp - nt) * tile))
    pad[7] = -1.0
    rp = torch.cat([rays, pad], 1)
    b = bounds.numpy()
    cov = np.zeros((6, 6, cpad), np.float32)     # geom/cluster.build_clusters' layout
    for ax in range(3):
        for h in range(2):
            cov[ax, 2 * ax + h, :n_clusters] = b[2 * ax + h, :n_clusters]
            cov[3 + ax, 2 * ax + h, :n_clusters] = 1.0
    planes = tuple(jnp.asarray(rp[i].reshape(ntp, 1, tile).numpy()) for i in range(8))
    jtn, jcb = jkp.coverage_tiles(planes, jnp.asarray(cov), n_clusters,
                                  n_live_tiles=jnp.int32(int(nlt[0])), interpret=True)
    jtn, jcb = np.asarray(jtn)[:nt], np.asarray(jcb)[:nt]
    tn, cb = tn.numpy(), cb.numpy()
    np.testing.assert_array_equal(np.isfinite(tn), np.isfinite(jtn))
    fin = np.isfinite(tn)
    np.testing.assert_allclose(tn[fin], jtn[fin], rtol=1e-5)

    def column_bits(words):                      # (nt, tile, cpad), real columns
        w = words.astype(np.int64)[..., None] >> np.arange(32)
        return (w & 1).transpose(0, 2, 1, 3).reshape(nt, tile, cpad)[..., :n_clusters]

    bits, jbits = column_bits(cb), column_bits(jcb)
    assert (bits == jbits).mean() >= 0.999, (bits != jbits).sum()
    assert bits.sum() > 100


def test_bench_primary_wavefront_enters_no_column_outside_its_word_box():
    res = 128
    scene = bench_scene(6, "cpu")
    cs, tile = scene.clusters, scene.tile
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = driver.lane_ids(cfg, 0, 1, "cpu")
    o, d, _, _ = driver.camera_rays(bench_camera((res, res), "cpu"), cfg,
                                    pid.reshape(-1), sid.reshape(-1))
    n = o.shape[0]
    _, rays, _ = tcl.prepare(cs, o, d, torch.full((n,), 1e-4),
                             torch.full((n,), float("inf")), tile)
    nlt = -(-int((rays[7] > rays[6]).sum()) // tile)
    tn, cb, run, needed = _counted(rays, cs.bounds, torch.tensor([nlt], dtype=torch.int32),
                                   cs.n_clusters, tile)
    entered = _np_word_entries(rays, cs.bounds, nlt, tile)
    _assert_superset(cb, entered, nlt)
    assert int((cb != 0).sum()) > 0
    assert run == needed == nlt * tile * entered.shape[-1] + 32 * int(entered.sum())
    assert 2 * run < nlt * tile * cs.bounds.shape[1]     # the flat count
