"""Two probe kernels of the TPU kernels' block structure, with their
wrappers and plain PyTorch versions. Neither is on a render path.

compact — replaces the probe `main` in debug_lc_prim2.py:89 (the rank-based
    lane compaction of the lane-compacted TPU kernels, which must return
    val·mask exactly). The CUDA kernel compacts a (1, tile) mask into a
    list with `compact_lanes` (rank-based, by ballots and a block scan),
    gathers val into the compacted domain and expands it back through the list. Returns out =
    val·mask and slot = 1 where the mask is set, else -1. Bound: launch
    latency (one block, a few KB).

overhead — replaces `run` in profile_overhead.py:111 (per-grid-step overhead
    of traverse_tiles' block structure). One block per tile, rounds of CH
    clusters in corder order, at the probe's shapes (NT = 1024 tiles of
    TILE = 256 lanes, CPAD = 1024, C = 900 clusters of K = 128 slots):
      empty          writes ray plane 0;
      stage          stages each round's clusters into shared memory
                     through `stage_clusters` and adds the first staged
                     feature per round;
      stage+compute  adds per lane the minimum over the round's CH·K slots
                     of the dot of the slot's first 16 features with the
                     lane's 8 ray planes taken twice.
    Bound: operations for stage+compute (32 f32 ops per (lane, slot)),
    bytes for the others. It measures the card's per-block cost of that
    structure (one block per tile, features staged in shared memory),
    which the tracers no longer use: `python -m pbrt_tpu_torch.kernels.probes` prints
    µs per tile for each kind and cluster count (needs a GPU).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. Each wrapper counts its launches in its
`launches` attribute.
"""
from __future__ import annotations

import numpy as np
import torch

from .cluster_cuda import CH, NF, _need, _ptr, _stream, load_library

NT, TILE, CPAD, C, K = 1024, 256, 1024, 900, 128
KINDS = ("empty", "stage", "stage+compute")
COUNTS = (0, 8, 32, 64)


# ----------------------------------------------------------- compaction

def compact_plain(mask, val):
    return val * mask, torch.where(mask > 0.5, 1, -1).to(torch.int32)


def compact(mask, val):
    """mask, val (1, tile) f32 → (out (1, tile) f32, slot (1, tile) i32)."""
    dev = mask.device
    tile = mask.shape[-1]
    if not 0 < tile <= 1024:
        raise ValueError(f"tile={tile}: must be in 1..1024")
    _need(mask, "mask", torch.float32, (1, tile), dev)
    _need(val, "val", torch.float32, (1, tile), dev)
    if dev.type != "cuda":
        return compact_plain(mask, val)
    out = torch.empty_like(val)
    slot = torch.empty((1, tile), dtype=torch.int32, device=dev)
    err = load_library().pbrt_compact_probe(_ptr(mask), _ptr(val), _ptr(out), _ptr(slot),
                                            tile, _stream(mask))
    if err:
        raise RuntimeError(f"compaction probe launch failed: cudaError {err}")
    compact.launches += 1
    return out, slot


compact.launches = 0


def compact_inputs(tile, device, seed=0, p=0.7):
    """The probe's mask (set with probability p) and val in [1, 101)."""
    r = np.random.RandomState(seed)
    mask = (r.rand(1, tile) < p).astype(np.float32)
    val = (r.rand(1, tile) * 100 + 1.0).astype(np.float32)
    return torch.as_tensor(mask, device=device), torch.as_tensor(val, device=device)


# ------------------------------------------------------------- overhead

def overhead_plain(kind, packed, planes, corder, counts, tile, chunk=8):
    """Plain PyTorch overhead probe, `chunk` tiles at a time; the kernel's
    arithmetic in its order. Same arguments and result as `overhead`."""
    nt = planes.shape[1] // tile
    P = planes.view(8, nt, tile)
    if kind == "empty":
        return P[0].clone()
    k = packed.shape[2]
    n_rounds = (counts.to(torch.int64) + CH - 1) // CH
    acc = torch.zeros((nt, tile), dtype=torch.float32, device=planes.device)
    for r in range(int(n_rounds.max()) if nt else 0):
        act = torch.nonzero(r < n_rounds)[:, 0]
        for a0 in range(0, act.numel(), chunk):
            idx = act[a0:a0 + chunk]
            cids = corder[idx, r * CH:(r + 1) * CH].to(torch.int64)
            if kind == "stage":
                acc[idx] = acc[idx] + packed[cids[:, 0], 0, 0][:, None]
                continue
            F = packed[cids][:, :, :16].permute(0, 2, 1, 3).reshape(len(idx), 16, CH * k)
            L = P[:, idx]                                         # (8, n, tile)
            d = F[:, None, 0] * L[0, ..., None]
            for q in range(1, 16):
                d = d + F[:, None, q] * L[q % 8, ..., None]
            acc[idx] = acc[idx] + d.amin(-1)
    return acc


def overhead(kind, packed, planes, corder, counts, tile):
    """kind in KINDS; packed (C, 24, K) f32; planes (8, nt·tile) f32;
    corder (nt, CPAD) i32; counts (nt,) i32 → out (nt, tile) f32."""
    dev = planes.device
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: expected one of {KINDS}")
    if tile % 32 or not 0 < tile <= 1024 or planes.dim() != 2 or planes.shape[1] % tile:
        raise ValueError("planes (8, nt*tile) with tile a multiple of 32, at most 1024")
    nt = planes.shape[1] // tile
    c, _, k = packed.shape
    cpad = corder.shape[-1]
    if cpad % CH:
        raise ValueError(f"corder width {cpad} must be a multiple of {CH}")
    _need(packed, "packed", torch.float32, (c, NF, k), dev)
    _need(planes, "planes", torch.float32, (8, nt * tile), dev)
    _need(corder, "corder", torch.int32, (nt, cpad), dev)
    _need(counts, "counts", torch.int32, (nt,), dev)
    if dev.type != "cuda":
        return overhead_plain(kind, packed, planes, corder, counts, tile)
    out = torch.empty((nt, tile), dtype=torch.float32, device=dev)
    err = load_library().pbrt_overhead_probe(KINDS.index(kind), _ptr(packed), _ptr(planes),
                                             _ptr(corder), _ptr(counts), _ptr(out), nt,
                                             tile, cpad, k, CH, _stream(planes))
    if err:
        raise RuntimeError(f"overhead probe launch failed: cudaError {err}")
    overhead.launches += 1
    return out


overhead.launches = 0


def overhead_inputs(count, device, nt=NT, tile=TILE, seed=0):
    """The probe's inputs from a numpy seed (not ones, so a wrong address
    shows): packed features in [-1, 1), ray planes in [-1, 1), per-tile
    random cluster orders, `count` clusters per tile."""
    r = np.random.RandomState(seed)
    packed = (r.rand(C, NF, K) * 2 - 1).astype(np.float32)
    planes = (r.rand(8, nt * tile) * 2 - 1).astype(np.float32)
    corder = r.randint(0, C, (nt, CPAD)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (t(packed), t(planes), t(corder),
            torch.full((nt,), count, dtype=torch.int32, device=device))


def overhead_ops(kind, count, nt=NT, tile=TILE, k=K):
    """f32 operations of one launch: 32 per (lane, slot) for stage+compute
    (16 products, 15 sums, one min), one sum per lane and round for stage."""
    rounds = nt * ((count + CH - 1) // CH)
    return {"empty": 0, "stage": rounds * tile,
            "stage+compute": rounds * tile * CH * k * 32}[kind]


def overhead_bytes(kind, count, nt=NT, tile=TILE, k=K):
    """Bytes one launch must move: its inputs read once, its output
    written once (packed only where staged)."""
    out = nt * tile * 4
    if kind == "empty":
        return 2 * out
    return out + 8 * nt * tile * 4 + nt * CPAD * 4 + nt * 4 + C * NF * k * 4


def run(kind, count, reps=5):
    """µs per tile of one launch of the probe at its shapes, by CUDA events."""
    args = overhead_inputs(count, "cuda")
    overhead(kind, *args, TILE)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        overhead(kind, *args, TILE)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps / NT * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the probes need a GPU")
    print("device:", torch.cuda.get_device_name(0), flush=True)
    for kind in KINDS:
        for count in ((0,) if kind == "empty" else COUNTS):
            us = run(kind, count)
            print(f"{kind:14s} counts={count:3d} rounds={NT * ((count + CH - 1) // CH):6d} "
                  f"{us * NT / 1e3:8.3f} ms {us:8.3f} us/tile", flush=True)


if __name__ == "__main__":
    main()
