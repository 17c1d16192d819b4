"""The tile×cluster tracer's three CUDA kernels, their wrappers and their
plain PyTorch versions.

coverage — replaces `coverage_tiles` (pbrt_tpu/kernels/cluster_pallas.py:303,
    kernel `_make_coverage_kernel`). The slab test of every lane against
    every cluster AABB; outputs the per-tile minimum entry t (nt, CPAD)
    and per-lane coverage bits (nt, CPAD/32, TILE). Design: a two-level
    walk. Each 32-column word has a box that holds its columns' boxes
    (`_word_boxes`); the slab test is monotone in the box faces, so a lane
    that misses a word's box misses all of its columns. A lane pass
    (blocks of 256 lanes) tests every lane against the word boxes, a
    ballot per word giving its lane mask: where no lane of a 32-lane
    chunk enters a word's box it stores the chunk's words as zeros, and
    it lists the other (tile, word, chunk) units. A column pass spreads
    the listed units over the whole launch: a warp walks a dense unit
    lane-parallel (a thread per lane, against the 32 columns in turn) and
    a sparse one column-parallel (a thread per column, a ballot per
    entering lane); tnear is merged by a float atomic min. Bound on the
    card: operations or bytes — 28 float32 ops per test, times the tests
    this run's data needs: TILE·CPAD/32 box tests per live tile plus 32
    per (lane, word) whose box the lane enters (`tests_needed`, equal to
    `tests_run`), 26.1M tests on the bench's primary wavefront where
    testing every pair takes 169.1M; the bytes are the rays in and the
    covbits out (most of them zeros).

closest — replaces `traverse_tiles` (cluster_pallas.py:876, default kernel
    `_make_closest_kernel_lc`). Closest hit per lane over the tile's
    covered clusters in ascending entry t, with fused shadow lanes
    (anyhit > 0). Bound on the card: operations — 49 float32 ops per
    Plücker slot test, times the slot tests this run's data needs: K per
    (lane, cluster) pair whose covbit is set, whose position lies within
    the tile's count and whose entry t is within the lane's best t at the
    start of the round (`needed_tests`). In practice the sparse rounds
    make each block wait on feature loads from L2 and on its barriers, and
    the blocks of the tiles with the longest cluster lists set the
    launch's time. Design: the TPU kernel tests all CH·K slots of a round
    for every lane that enters one of its clusters; here a round lists
    exactly the pairs above and runs K tests per pair (`slot_tests`
    equals `needed_tests`). A block of BLOCK lanes walks its tile's rounds
    on its own (the early stop compares the next entry t with the max
    best t of the block's lanes), six blocks share an SM, and block b
    takes the tile of rank b·BLOCK/tile by descending count (one small
    block sorts the tiles by count before each launch), so the longest
    chains of rounds start first. A warp takes a unit: 32 slots of
    one round cluster against a work item of at least 32 of the lanes
    listed for it; it holds the slots' features in registers, loaded
    straight from `packed` (C, 24, K), reads each lane's ray as a
    shared-memory broadcast and puts a hit's (t|slot) key into the lane's
    int by atomicMin in shared memory, so the result does not depend on
    the order of the hits. The features never pass through shared memory,
    whose read pipe (96 bytes a test) bounded the earlier design.

occluded — replaces `occluded_tiles` (cluster_pallas.py:924, default
    kernel `_make_anyhit_kernel_lc`). Any hit per lane: does a triangle of
    a covered cluster lie at tmin < t < tmax, the exact window (the fused
    shadow lanes of `closest` compare a t with 11 cleared mantissa bits).
    Bound on the card: operations — 49 float32 ops per Plücker slot test
    plus the two window compares, times the slot tests this run's data
    needs: per lane, the slots of the clusters it enters, in order, up to
    its first hit (`needed_tests`); the same waits as `closest` in
    practice. Design: `closest`'s blocks, order, pair lists and
    register-held units; a pair is a covbit set within the count of a
    lane live and not yet occluded at the start of the round, and runs K
    tests (`slot_tests`), so only the slots after a lane's first hit are
    run and not needed. A hit writes its round position into the lane's
    int by atomicMin, which gives the first hit for the needed count; a
    block stops once every live lane of its own is occluded (a
    block-wide vote).

The library also holds the probes' kernels (kernels/probes.py) and the
backward of a row gather (`row_grad`, diff/rows.py).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. The plain versions repeat the kernels'
arithmetic op for op (the kernels are built with -fmad=false), so the two
agree bit for bit on the card. Each wrapper counts its launches in its
`launches` attribute.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import torch

from ..core.types import INF, f32

CH = 8                 # clusters per traversal round
BLOCK = 128            # lanes per closest-hit and any-hit block (kernels/csrc/cluster.cu)
NF = 24                # features per triangle slot (kernels/csrc/cluster.cu)
SLOT_MASK = 2047       # low mantissa bits of t that carry the slot
COV_CLUSTERS = 128     # CPAD is a multiple (geom/cluster.build_clusters)
THREADS = 256          # TILE is a multiple of it, at most 4x
_BIG = f32(3e37)
_INT_MAX = 0x7FFFFFFF

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "cluster.cu")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_lock = threading.Lock()
_lib = None
build_seconds = None     # seconds the last build took (None: loaded from cache)


def _nvcc():
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path():
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libcluster-{tag}.so")


def load_library():
    """Build (at first use, keyed by a hash of the source and flags) and
    load the kernel library."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, _SRC],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stderr}")
            os.replace(tmp, so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.pbrt_coverage_counted.restype = i
        lib.pbrt_coverage_counted.argtypes = [p] * 7 + [i] * 4 + [p]
        lib.pbrt_closest.restype = i
        lib.pbrt_closest.argtypes = [p] * 12 + [i] * 6 + [p]
        lib.pbrt_occluded.restype = i
        lib.pbrt_occluded.argtypes = [p] * 8 + [i] * 6 + [p]
        lib.pbrt_compact_probe.restype = i
        lib.pbrt_compact_probe.argtypes = [p, p, p, p, i, p]
        lib.pbrt_overhead_probe.restype = i
        lib.pbrt_overhead_probe.argtypes = [i] + [p] * 5 + [i] * 5 + [p]
        lib.pbrt_launch_floor.restype = i
        lib.pbrt_launch_floor.argtypes = [p]
        lib.pbrt_row_grad.restype = i
        lib.pbrt_row_grad.argtypes = [p] * 5 + [ctypes.c_longlong] + [i] * 3 + [p]
        _lib = lib
        return lib


def _ptr(x):
    return ctypes.c_void_p(x.data_ptr())


def _opt_ptr(x):
    """A tensor's pointer, or NULL for None."""
    return ctypes.c_void_p(0) if x is None else _ptr(x)


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _need(x, name, dtype, shape, device):
    if not torch.is_tensor(x):
        raise TypeError(f"{name}: expected a tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_tile(tile):
    if tile % THREADS or not 0 < tile <= 4 * THREADS:
        raise ValueError(f"tile={tile}: must be a multiple of {THREADS}, at most {4 * THREADS}")


# ------------------------------------------------------------- coverage

def _word_boxes(bounds):
    """(6, CPAD/32) f32: each 32-column word's box, per axis the least of
    min(lo, hi) and the greatest of max(lo, hi) over its columns, pad
    columns as `bounds` holds them. Every column's box lies inside it."""
    b = bounds.view(3, 2, -1, 32)
    lo = torch.minimum(b[:, 0], b[:, 1]).amin(-1)
    hi = torch.maximum(b[:, 0], b[:, 1]).amax(-1)
    return torch.stack([lo, hi], 1).reshape(6, -1)


def _slab(boxes, inv, noi, tn, tf):
    """The kernel's slab test of rays (their inv, noi per axis, tmin and
    tmax, each (..., 1)) against boxes (6, m), in its order of operations.
    Returns (tn, entered), each (..., m)."""
    for ax in range(3):
        lo = boxes[2 * ax] * inv[ax] + noi[ax]
        hi = boxes[2 * ax + 1] * inv[ax] + noi[ax]
        tn = torch.maximum(tn, torch.minimum(lo, hi))
        tf = torch.minimum(tf, torch.maximum(lo, hi) * f32(1.0001))
    return tn, tn <= tf


def coverage_plain(rays, bounds, n_live_tiles, n_clusters, tile, chunk=8,
                   tests_run=None, tests_needed=None):
    """Plain PyTorch coverage, `chunk` tiles at a time (None: all at once):
    every lane against every column. Same arguments and results as
    `coverage`. Given the counters, it adds the kernel's counts, from a
    test of every live tile's lanes against the word boxes with the same
    arithmetic."""
    nt = rays.shape[1] // tile
    cpad = bounds.shape[1]
    dev = rays.device
    tnear = torch.full((nt, cpad), INF, dtype=torch.float32, device=dev)
    covbits = torch.zeros((nt, cpad // 32, tile), dtype=torch.int32, device=dev)
    live = min(int(n_live_tiles.reshape(-1)[0]), nt)
    R = rays.view(8, nt, tile)
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    counting = tests_run is not None or tests_needed is not None
    boxes = _word_boxes(bounds) if counting else None
    entries = 0
    step = live if chunk is None else chunk
    for s in range(0, live, max(step, 1)):
        e = min(s + step, live)
        inv, noi = [], []
        for ax in range(3):
            o = R[ax, s:e, :, None]
            d = R[3 + ax, s:e, :, None]
            dd = torch.where(d.abs() < f32(1e-12),
                             torch.where(d < 0.0, f32(-1e-12), f32(1e-12)), d)
            inv.append(1.0 / dd)
            noi.append((-o) * inv[-1])
        tmin = torch.clamp(R[6, s:e, :, None], -_BIG, _BIG)
        tmax = torch.clamp(R[7, s:e, :, None], -_BIG, _BIG)
        tn, hit = _slab(bounds, inv, noi, tmin, tmax)          # (n, tile, cpad)
        tnear[s:e] = torch.where(hit, tn, INF).amin(1)
        words = (hit.view(e - s, tile, cpad // 32, 32).to(torch.int64)
                 << shifts).sum(-1)
        words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
        covbits[s:e] = words.to(torch.int32).permute(0, 2, 1)
        if counting:
            entries += int(_slab(boxes, inv, noi, tmin, tmax)[1].sum())
    tnear[:, n_clusters:] = INF
    if counting:
        n = live * tile * (cpad // 32) + 32 * entries
        for c in (tests_run, tests_needed):
            if c is not None:
                c += n
    return tnear, covbits


def coverage(rays, bounds, n_live_tiles, n_clusters, tile, tests_run=None,
             tests_needed=None):
    """Per-tile cluster coverage.

    rays (8, nt·tile) f32 sorted planes ox oy oz dx dy dz tmin tmax;
    bounds (6, CPAD) f32; n_live_tiles (1,) i32 — tiles at or past it
    write INF and 0. Returns tnear (nt, CPAD) f32 (INF where no lane
    enters, and in columns >= n_clusters) and covbits (nt, CPAD/32, tile)
    i32. `tests_run` (1,) int64, when given, accumulates the slab tests
    run; `tests_needed` the tests the two-level walk needs: CPAD/32 word
    box tests for every lane of a live tile, plus 32 for every (lane,
    word) whose box the lane enters."""
    dev = rays.device
    _check_tile(tile)
    if rays.dim() != 2 or rays.shape[0] != 8 or rays.shape[1] % tile:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected (8, nt*{tile})")
    nt = rays.shape[1] // tile
    cpad = bounds.shape[-1]
    if cpad % COV_CLUSTERS or not 0 < n_clusters <= cpad:
        raise ValueError(f"bounds width {cpad} must be a multiple of {COV_CLUSTERS} "
                         f"holding {n_clusters} clusters")
    _need(rays, "rays", torch.float32, (8, nt * tile), dev)
    _need(bounds, "bounds", torch.float32, (6, cpad), dev)
    _need(n_live_tiles, "n_live_tiles", torch.int32, (1,), dev)
    for a, name in ((tests_run, "tests_run"), (tests_needed, "tests_needed")):
        if a is not None:
            _need(a, name, torch.int64, (1,), dev)
    if dev.type != "cuda":
        return coverage_plain(rays, bounds, n_live_tiles, n_clusters, tile,
                              tests_run=tests_run, tests_needed=tests_needed)
    lib = load_library()
    tnear = torch.empty((nt, cpad), dtype=torch.float32, device=dev)
    covbits = torch.empty((nt, cpad // 32, tile), dtype=torch.int32, device=dev)
    err = lib.pbrt_coverage_counted(_ptr(rays), _ptr(bounds), _ptr(n_live_tiles),
                                    _ptr(tnear), _ptr(covbits), _opt_ptr(tests_run),
                                    _opt_ptr(tests_needed), nt, tile, cpad, n_clusters,
                                    _stream(rays))
    if err:
        raise RuntimeError(f"coverage kernel launch failed: cudaError {err}")
    coverage.launches += 1
    return tnear, covbits


coverage.launches = 0


# ---------------------------------------------------------- closest hit

def _check_trace_args(packed, rays, corder, tnear, counts, covbits, tile, slot_tests,
                      needed_tests):
    """Device, dtype, shape and contiguity checks shared by the closest-hit
    and any-hit wrappers. Returns (nt, W, nb32, k)."""
    dev = rays.device
    _check_tile(tile)
    if rays.dim() != 2 or rays.shape[0] != 8 or rays.shape[1] % tile:
        raise ValueError(f"rays: shape {tuple(rays.shape)}, expected (8, nt*{tile})")
    nt = rays.shape[1] // tile
    c, nf, k = packed.shape
    W = corder.shape[1] if corder.dim() == 2 else -1
    if nf != NF or CH * k > SLOT_MASK + 1 or W % CH:
        raise ValueError(f"packed (C, {NF}, K) with {CH}·K <= {SLOT_MASK + 1} and "
                         f"corder width a multiple of {CH} required")
    nb32 = covbits.shape[1] if covbits.dim() == 3 else -1
    _need(packed, "packed", torch.float32, (c, NF, k), dev)
    _need(rays, "rays", torch.float32, (8, nt * tile), dev)
    _need(corder, "corder", torch.int32, (nt, W), dev)
    _need(tnear, "tnear", torch.float32, (nt, W), dev)
    _need(counts, "counts", torch.int32, (nt,), dev)
    _need(covbits, "covbits", torch.int32, (nt, nb32, tile), dev)
    for a, name in ((slot_tests, "slot_tests"), (needed_tests, "needed_tests")):
        if a is not None:
            _need(a, name, torch.int64, (1,), dev)
    return nt, W, nb32, k


def _check_kernel_shape(k, tile):
    """What the tracing kernels take beyond the plain versions: K a power
    of two of 32-slot units, whole blocks of BLOCK lanes."""
    units = k // 32
    if k % 32 or units & (units - 1) or tile % BLOCK:
        raise ValueError(f"the CUDA tracers need K = 32·2^n (K={k}) and tile a multiple "
                         f"of {BLOCK} (tile={tile})")


def _round_features(packed, cids):
    """The round's slots (n, NF, CH·K), slot j·K + kk = cluster j's slot kk."""
    return packed[cids].permute(0, 2, 1, 3).reshape(cids.shape[0], NF, -1)


def _round_mask(covbits, idx, cids):
    """(n, CH, tile) bool: lane enters round cluster j (its covbit)."""
    words = covbits[idx[:, None], cids // 32]
    return ((words >> (cids % 32).to(torch.int32)[..., None]) & 1) != 0


def _listed(mask):
    """The kernels' per-round lane list for the plain versions: each row's
    lanes with mask set first, in lane order, cut to the longest row.
    Returns (lanes (n, m) int64, listed (n, m) bool), or None when no lane
    is listed. Every lane's test is its own, so testing only the listed
    lanes changes no result."""
    m = int(mask.sum(1).max()) if mask.numel() else 0
    if m == 0:
        return None
    lanes = torch.argsort((~mask).to(torch.int32), dim=1, stable=True)[:, :m]
    return lanes, torch.gather(mask, 1, lanes)


def _slot_test(feat, ox, oy, oz, dx, dy, dz, mx, my, mz):
    """Plücker volumes, n·d and the plane numerator for every lane
    against every slot of the round; the kernel's arithmetic order."""
    F = lambda i: feat[:, i, None, :]   # noqa: E731  (n, 1, slots)

    def pl(b):
        return (((((dx * F(b) + dy * F(b + 1)) + dz * F(b + 2)) + mx * F(b + 3))
                 + my * F(b + 4)) + mz * F(b + 5))

    nd = (dx * F(18) + dy * F(19)) + dz * F(20)
    tnum = (((-F(18)) * ox + (-F(19)) * oy) + (-F(20)) * oz) + F(21)
    return pl(0), pl(6), pl(12), nd, tnum


def _lane_planes(R):
    """The kernels' per-lane ray planes from rays (8, nt, tile): origin,
    direction and the Plücker moment m = o × d."""
    ox, oy, oz, dx, dy, dz = (R[i] for i in range(6))
    return (ox, oy, oz, dx, dy, dz, oy * dz - oz * dy, oz * dx - ox * dz,
            ox * dy - oy * dx)


def _round_tests(packed, cids, idx, lanes, planes, tmin):
    """One round's slot tests for the listed lanes of tiles idx (lanes
    (n, m)): the Plücker volumes, n·d, plane numerator and t of every
    listed lane against every slot of the round's clusters, and ok = the
    line passes inside and t > tmin. Each (n, m, CH·K)."""
    lane = lambda a: torch.gather(a[idx], 1, lanes)[..., None]   # noqa: E731
    w0, w1, w2, nd, tnum = _slot_test(_round_features(packed, cids),
                                      *(lane(a) for a in planes))
    hm = torch.minimum(torch.minimum(w0 * nd, w1 * nd), w2 * nd)
    t = tnum * (1.0 / nd)
    return w0, w1, w2, nd, tnum, t, (hm >= 0.0) & (t > lane(tmin))


def _round_positions(counts, idx, r):
    """(n, CH) bool: round r's position j lies within the tile's count
    (positions past it repeat a cluster and are not needed)."""
    pos = r * CH + torch.arange(CH, device=counts.device)
    return pos < counts[idx].to(torch.int64)[:, None]


def closest_plain(packed, rays, anyhit, corder, tnear, counts, covbits, tile,
                  slot_tests=None, needed_tests=None, chunk=8, block=BLOCK, prune=True):
    """Plain PyTorch closest hit. Same arguments and results as `closest`.
    Each tile is cut into blocks of `block` lanes that walk the tile's
    rounds on their own, as the kernel's blocks do; `prune=False` walks
    every round (the early stop only saves work: a lane whose best t lies
    below the next entry t joins no later pair). The blocks run in
    lock-step by round, those of `chunk` tiles at a time (None: all at
    once), each round testing the (lane, cluster) pairs listed for it
    only."""
    nt = rays.shape[1] // tile
    q = tile // block
    if q > 1:   # the same memory as nt·q tiles of `block` lanes
        nb32 = covbits.shape[1]
        rep = lambda a: a.repeat_interleave(q, 0)   # noqa: E731
        t, slot, bary = closest_plain(
            packed, rays, anyhit, rep(corder), rep(tnear), rep(counts),
            covbits.view(nt, nb32, q, block).permute(0, 2, 1, 3).reshape(nt * q, nb32, block),
            block, slot_tests, needed_tests, None if chunk is None else chunk * q, block,
            prune)
        return (t.view(nt, tile), slot.view(nt, tile),
                bary.view(nt, q, 2, block).permute(0, 2, 1, 3).reshape(nt, 2, tile))
    dev = rays.device
    c, _, k = packed.shape
    W = corder.shape[1]
    chk = CH * k
    R = rays.view(8, nt, tile)
    tmin = torch.clamp(R[6], -_BIG, _BIG)
    t_best = torch.clamp(R[7], -_BIG, _BIG).clone()
    tb = torch.stack([t_best, torch.zeros_like(t_best), torch.zeros_like(t_best)], 1)
    slot = torch.full((nt, tile), -1, dtype=torch.int32, device=dev)
    ah = (anyhit.view(nt, tile) > 0.0) if anyhit is not None else \
        torch.zeros((nt, tile), dtype=torch.bool, device=dev)
    n_rounds = (counts.to(torch.int64) + CH - 1) // CH
    dead = n_rounds == 0
    tb[dead, 0] = R[7][dead]
    done = dead.clone()
    slot_iota = torch.arange(chk, dtype=torch.int32, device=dev)
    planes = _lane_planes(R)
    for r in range(int(n_rounds.max()) if nt else 0):
        act = torch.nonzero(~done & (r < n_rounds))[:, 0]
        if act.numel() == 0:
            break
        step = act.numel() if chunk is None else chunk
        for a0 in range(0, act.numel(), step):
            idx = act[a0:a0 + step]
            cids = corder[idx, r * CH:(r + 1) * CH].to(torch.int64)   # (n, CH)
            tns = tnear[idx, r * CH:(r + 1) * CH]
            tbest = t_best[idx]                                       # (n, tile)
            # (n, CH, tile) the pairs: the lane enters cluster j (its
            # covbit), whose entry t is within its best t
            pairs = (_round_mask(covbits, idx, cids) & (tbest[:, None, :] >= tns[..., None])
                     & _round_positions(counts, idx, r)[..., None])
            n_pairs = pairs.sum()
            if slot_tests is not None:
                slot_tests += n_pairs * k
            if needed_tests is not None:
                needed_tests += n_pairs * k
            lst = _listed(pairs.any(1))
            if lst is None:
                continue
            lanes, listed = lst
            w0, w1, w2, nd, tnum, t, ok = _round_tests(packed, cids, idx, lanes, planes,
                                                       tmin)
            paired = torch.gather(pairs, 2, lanes[:, None, :].expand(-1, CH, -1))
            ok &= paired.permute(0, 2, 1).repeat_interleave(k, 2)     # (n, m, CH·K)
            key = torch.where(ok, (t.view(torch.int32) & ~SLOT_MASK) | slot_iota,
                              _INT_MAX)
            kmin = key.amin(-1)                                       # (n, m)
            tj = (kmin & ~SLOT_MASK).view(torch.float32)
            tb_l = torch.gather(tbest, 1, lanes)
            upd = listed & (tj < tb_l)
            # (lanes without a candidate carry INT_MAX: clamp their gather)
            s = torch.clamp((kmin & SLOT_MASK).to(torch.int64), max=chk - 1)[..., None]
            pick = lambda a: torch.gather(a, -1, s)[..., 0]   # noqa: E731
            s_nd, s_tnum = pick(nd), pick(tnum)
            s_w0, s_w1, s_w2 = pick(w0), pick(w1), pick(w2)
            s_t = s_tnum / torch.where(s_nd.abs() > f32(1e-12), s_nd, f32(1e-12))
            s_sum = (s_w0 + s_w1) + s_w2
            inv = 1.0 / torch.where(s_sum.abs() > f32(1e-30), s_sum, f32(1e-30))
            jwin = s[..., 0] // k
            gslot = torch.gather(cids, 1, jwin) * k + s[..., 0] % k
            cand = torch.stack([s_t, s_w2 * inv, s_w0 * inv], 1)
            tb_i, slot_i = tb[idx], slot[idx]
            l3 = lanes[:, None, :].expand(-1, 3, -1)
            tb[idx] = tb_i.scatter(2, l3, torch.where(upd[:, None], cand,
                                                      torch.gather(tb_i, 2, l3)))
            slot[idx] = slot_i.scatter(1, lanes, torch.where(
                upd, gslot.to(torch.int32), torch.gather(slot_i, 1, lanes)))
            t_best[idx] = tbest.scatter(1, lanes, torch.where(
                upd, torch.where(torch.gather(ah[idx], 1, lanes), -1.0, tj), tb_l))
        if prune:
            nxt = min((r + 1) * CH, W - 1)
            done[act] = tnear[act, nxt] >= t_best[act].amax(1)
    return tb[:, 0].contiguous(), slot, tb[:, 1:].contiguous()


def closest(packed, rays, anyhit, corder, tnear, counts, covbits, tile,
            slot_tests=None, needed_tests=None):
    """Closest hit over each tile's covered clusters.

    packed (C, 24, K) f32; rays (8, nt·tile) f32; anyhit (nt·tile,) f32
    or None (lanes > 0 are shadow rays: occluded ⇔ slot >= 0); corder
    (nt, W) i32 / tnear (nt, W) f32 per-tile cluster order, ascending entry
    t, W a multiple of CH; counts (nt,) i32 covered clusters per tile;
    covbits (nt, CPAD/32, tile) i32. Returns t (nt, tile) f32 exact plane
    t, slot (nt, tile) i32 GLOBAL slot cluster_id·K + lane or -1, bary
    (nt, 2, tile) f32 (b1, b2). `slot_tests` (1,) int64, when given,
    accumulates the number of Plücker slot tests run; `needed_tests` the
    tests the function needs: K per (lane, cluster) pair whose covbit is
    set and whose entry t is within the lane's best t at the start of the
    round, positions past counts left out."""
    dev = rays.device
    nt, W, nb32, k = _check_trace_args(packed, rays, corder, tnear, counts, covbits,
                                       tile, slot_tests, needed_tests)
    if anyhit is not None:
        _need(anyhit, "anyhit", torch.float32, (nt * tile,), dev)
    if dev.type != "cuda":
        return closest_plain(packed, rays, anyhit, corder, tnear, counts,
                             covbits, tile, slot_tests, needed_tests)
    _check_kernel_shape(k, tile)
    lib = load_library()
    t_out = torch.empty((nt, tile), dtype=torch.float32, device=dev)
    slot = torch.empty((nt, tile), dtype=torch.int32, device=dev)
    bary = torch.empty((nt, 2, tile), dtype=torch.float32, device=dev)
    err = lib.pbrt_closest(_ptr(packed), _ptr(rays), _opt_ptr(anyhit), _ptr(corder),
                           _ptr(tnear), _ptr(counts), _ptr(covbits), _ptr(t_out),
                           _ptr(slot), _ptr(bary), _opt_ptr(slot_tests),
                           _opt_ptr(needed_tests), nt, tile, W, nb32, k, CH,
                           _stream(rays))
    if err:
        raise RuntimeError(f"closest-hit kernel launch failed: cudaError {err}")
    closest.launches += 1
    return t_out, slot, bary


closest.launches = 0


# -------------------------------------------------------------- any hit

def occluded_plain(packed, rays, corder, tnear, counts, covbits, tile,
                   slot_tests=None, needed_tests=None, chunk=8):
    """Plain PyTorch any hit, tiles in lock-step by round, `chunk` tiles
    at a time (None: all at once), each round testing the (lane, cluster)
    pairs listed for it only: the lane enters the cluster (its covbit),
    the position lies within the tile's count, and the lane is live and
    not yet occluded at the start of the round. Same arguments and
    results as `occluded`. Cutting a tile into the kernel's blocks changes
    nothing here: an occluded or dead lane joins no pair, so the blocks'
    early stop only saves work. The slot-test counts follow the kernel's:
    K per pair run, and the needed count keeps each lane's pairs up to its
    first hit in (cluster position, slot) order."""
    dev = rays.device
    nt = rays.shape[1] // tile
    k = packed.shape[2]
    R = rays.view(8, nt, tile)
    tmin = torch.clamp(R[6], -_BIG, _BIG)
    tmax = torch.clamp(R[7], -_BIG, _BIG)
    live = tmax > tmin
    occ = torch.zeros((nt, tile), dtype=torch.bool, device=dev)
    n_rounds = (counts.to(torch.int64) + CH - 1) // CH
    done = n_rounds == 0
    planes = _lane_planes(R)
    kk = torch.arange(k, dtype=torch.int64, device=dev)
    for r in range(int(n_rounds.max()) if nt else 0):
        done |= (occ | ~live).all(1)        # the kernel's vote, before each round
        act = torch.nonzero(~done & (r < n_rounds))[:, 0]
        if act.numel() == 0:
            break
        step = act.numel() if chunk is None else chunk
        for a0 in range(0, act.numel(), step):
            idx = act[a0:a0 + step]
            cids = corder[idx, r * CH:(r + 1) * CH].to(torch.int64)   # (n, CH)
            pairs = (_round_mask(covbits, idx, cids)                  # (n, CH, tile)
                     & _round_positions(counts, idx, r)[..., None]
                     & (live[idx] & ~occ[idx])[:, None, :])
            lst = _listed(pairs.any(1))
            if lst is None:
                continue
            lanes, listed = lst
            m = lanes.shape[1]
            paired = torch.gather(pairs, 2, lanes[:, None, :].expand(-1, CH, -1)) \
                .permute(0, 2, 1)                                    # (n, m, CH)
            t, ok = _round_tests(packed, cids, idx, lanes, planes, tmin)[5:]
            ok = (ok & (t < torch.gather(tmax[idx], 1, lanes)[..., None])).view(
                len(idx), m, CH, k) & paired[..., None]              # (n, m, CH, K)
            hit = ok.any(-1)                                         # (n, m, CH)
            if slot_tests is not None:
                slot_tests += paired.sum() * k
            if needed_tests is not None:
                # each pair's slots up to its first hit, else K; pairs after
                # the lane's first hitting pair left out
                ran = torch.where(hit, torch.where(ok, kk, k).amin(-1) + 1, k)
                h = hit.to(torch.int64)
                earlier = (torch.cumsum(h, -1) - h) > 0
                needed_tests += torch.where(paired & ~earlier, ran, 0).sum()
            occ_i = occ[idx]
            occ[idx] = occ_i.scatter(1, lanes, torch.gather(occ_i, 1, lanes)
                                     | (listed & hit.any(-1)))
    return occ


def occluded(packed, rays, corder, tnear, counts, covbits, tile, slot_tests=None,
             needed_tests=None):
    """Any hit over each tile's covered clusters.

    Same inputs as `closest` without `anyhit` (tnear carries the tile's
    order contract; the any-hit kernel needs only corder). Returns occ
    (nt, tile) bool: some triangle lies at tmin < t < tmax. `slot_tests`
    (1,) int64, when given, accumulates the Plücker slot tests run;
    `needed_tests` the tests the function needs: per lane, the slots of
    the clusters its covbits name, in corder and slot order, up to its
    first hit (positions past counts left out)."""
    dev = rays.device
    nt, W, nb32, k = _check_trace_args(packed, rays, corder, tnear, counts, covbits,
                                       tile, slot_tests, needed_tests)
    if dev.type != "cuda":
        return occluded_plain(packed, rays, corder, tnear, counts, covbits, tile,
                              slot_tests, needed_tests)
    _check_kernel_shape(k, tile)
    lib = load_library()
    occ = torch.empty((nt, tile), dtype=torch.bool, device=dev)
    err = lib.pbrt_occluded(_ptr(packed), _ptr(rays), _ptr(corder), _ptr(counts),
                            _ptr(covbits), _ptr(occ), _opt_ptr(slot_tests),
                            _opt_ptr(needed_tests), nt, tile, W, nb32, k, CH,
                            _stream(rays))
    if err:
        raise RuntimeError(f"any-hit kernel launch failed: cudaError {err}")
    occluded.launches += 1
    return occ


occluded.launches = 0


def resource_usage(src=_SRC):
    """Registers and spill-store bytes of each kernel of a source file, as
    `nvcc -Xptxas -v` reports them with the build's flags. Returns
    {kernel name: (registers, spill store bytes)}."""
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o",
                              os.path.join(tmp, "lib.so"), src],
                             capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    return ptxas_usage(res.stderr)


def ptxas_usage(log):
    """{kernel name: (registers, spill store bytes)} from the output of
    `nvcc -Xptxas -v`; a template's instantiations share a name and give
    their most registers and most spill bytes."""
    out, name, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?([a-z_]+_kernel)", line)
        if m:
            name, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            r, b = out.get(name, (0, 0))
            out[name] = (max(r, int(m.group(1))), max(b, spill))
            name = None
    return out


if __name__ == "__main__":
    # python -m pbrt_tpu_torch.kernels.cluster_cuda [source.cu]
    for kname, (regs, spill) in resource_usage(*sys.argv[1:2]).items():
        print(f"{kname}: registers={regs} spill_store_bytes={spill}")
