"""Two probe kernels of the TPU kernels' block structure, with their
wrappers and plain PyTorch versions. Neither is on a render path.

compact — replaces the probe `main` in debug_lc_prim2.py:89 (body `kernel`
    :38: the rank-based lane compaction of the lane-compacted TPU kernels).
    A lane is set where mask > 0.5. The CUDA kernel ranks the set
    lanes of a (1, tile) mask in one pass (a ballot and popcount within
    each warp, the warp totals scanned by warp 0), lists them, gathers val
    into the compacted domain and expands it back through the list.
    Returns out = val and slot = 1 where the lane is set and val is
    nonzero, else out = 0 and slot = -1: the reference expands a lane only
    where its gathered value is nonzero, so a set lane whose val is 0 or
    -0.0 comes back as an unset one. Bound: launch latency (one block, a
    few KB).

overhead — replaces `run` in profile_overhead.py:111 (body `make` :38: the
    per-grid-step overhead of traverse_tiles' block structure). One block
    per tile, rounds of CH = 8 clusters in corder order; a cluster is
    16 features × n5 × K slots, `packed` (C, 16, n5, K) as the reference
    lays it out (n5 = 5, K = 128 at the probe's shapes: NT = 1024 tiles of
    TILE = 256 lanes, CPAD = 1024, C = 900):
      empty          writes ray plane 0;
      stage          stages every cluster of each round into shared
                     memory and adds packed[first cluster of the round,
                     0, 0, 0] per round;
      stage+compute  adds per lane and round the minimum over the round's
                     CH·n5·K slots of Σ_q F[q]·plane[q mod 8], q = 0..15
                     (the product for q = 0 first, then q = 1..15 added in
                     turn).
    A round stages all CH of its clusters, even where the tile's count
    ends inside it. The kernel stages through a ring of cluster buffers
    filled by bulk copies (two 40 KB buffers at n5 = 5, two blocks an SM).
    Bound: operations for stage+compute (32 f32 ops per (lane, slot)); the
    kernel builds with -fmad=false, so its 16 products and 15 sums issue
    as separate instructions, at half of the rate that the bound assumes
    (`overhead_ceiling_ops`).
    `python -m pbrt_tpu_torch.kernels.probes` prints µs per tile for each
    kind, cluster count and n5 (needs a GPU).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version. Each wrapper counts its launches in its
`launches` attribute. `launch_floor` launches an empty kernel, the floor
any one-block launch stands on (no counter: it replaces no TPU kernel).
"""
from __future__ import annotations

import numpy as np
import torch

from .cluster_cuda import _need, _ptr, _stream, load_library

NT, TILE, CPAD, C, CH, K, N5 = 1024, 256, 1024, 900, 8, 128, 5
NFEAT = 16             # features per slot the probe reads
KINDS = ("empty", "stage", "stage+compute")
COUNTS = (0, 8, 32, 64)


# ----------------------------------------------------------- compaction

def compact_plain(mask, val):
    """val where mask > 0.5 and val != 0, else 0; slot 1 there, else -1."""
    on = (mask > 0.5) & (val != 0)
    return torch.where(on, val, torch.zeros_like(val)), torch.where(on, 1, -1).to(torch.int32)


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


def compact_inputs(tile, device, seed=0, p=0.7, zeros=False):
    """The probe's mask (set with probability p) and val in [1, 101);
    with `zeros`, val is also 0 at every 9th lane and -0.0 at the lane 4
    after each of those."""
    r = np.random.RandomState(seed)
    mask = (r.rand(1, tile) < p).astype(np.float32)
    val = (r.rand(1, tile) * 100 + 1.0).astype(np.float32)
    if zeros:
        val[0, ::9], val[0, 4::9] = 0.0, -0.0
    return torch.as_tensor(mask, device=device), torch.as_tensor(val, device=device)


def launch_floor(device):
    """Launches one empty one-block kernel on `device`'s current stream."""
    err = load_library().pbrt_launch_floor(
        _stream(torch.empty(0, device=device)))
    if err:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")


# ------------------------------------------------------------- overhead

def overhead_plain(kind, packed, planes, corder, counts, tile, chunk=8):
    """Plain PyTorch overhead probe, `chunk` tiles at a time; the kernel's
    arithmetic in its order. Same arguments and result as `overhead`."""
    nt = planes.shape[1] // tile
    P = planes.view(8, nt, tile)
    if kind == "empty":
        return P[0].clone()
    n_slots = CH * packed.shape[2] * packed.shape[3]
    # ceil(count / CH) rounds, clamped to [0, cpad / CH] as the kernel does
    n_rounds = ((counts.to(torch.int64) + CH - 1) // CH).clamp(0, corder.shape[1] // CH)
    acc = torch.zeros((nt, tile), dtype=torch.float32, device=planes.device)
    for r in range(int(n_rounds.max()) if nt else 0):
        act = torch.nonzero(r < n_rounds)[:, 0]
        for a0 in range(0, act.numel(), chunk):
            idx = act[a0:a0 + chunk]
            cids = corder[idx, r * CH:(r + 1) * CH].to(torch.int64)
            if kind == "stage":
                acc[idx] = acc[idx] + packed[cids[:, 0], 0, 0, 0][:, None]
                continue
            F = packed[cids].transpose(1, 2).reshape(len(idx), NFEAT, n_slots)
            L = P[:, idx]                                         # (8, n, tile)
            d = F[:, None, 0] * L[0, ..., None]
            for q in range(1, NFEAT):
                d = d + F[:, None, q] * L[q % 8, ..., None]
            acc[idx] = acc[idx] + d.amin(-1)
    return acc


def overhead(kind, packed, planes, corder, counts, tile):
    """kind in KINDS; packed (C, 16, n5, K) f32; planes (8, nt·tile) f32;
    corder (nt, CPAD) i32 with ids in [0, C); counts (nt,) i32 → out
    (nt, tile) f32."""
    dev = planes.device
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r}: expected one of {KINDS}")
    if tile % 64 or not 0 < tile <= 1024 or planes.dim() != 2 or planes.shape[1] % tile:
        raise ValueError("planes (8, nt*tile) with tile a multiple of 64, at most 1024")
    nt = planes.shape[1] // tile
    if packed.dim() != 4 or packed.shape[1:] not in ((NFEAT, N5, K), (NFEAT, 1, K)):
        raise ValueError(f"packed {tuple(packed.shape)}: expected (C, {NFEAT}, n5, {K}), "
                         f"n5 {N5} or 1")
    c, _, n5, k = packed.shape
    cpad = corder.shape[-1]
    if cpad % CH:
        raise ValueError(f"corder width {cpad} must be a multiple of {CH}")
    _need(packed, "packed", torch.float32, (c, NFEAT, n5, k), dev)
    _need(planes, "planes", torch.float32, (8, nt * tile), dev)
    _need(corder, "corder", torch.int32, (nt, cpad), dev)
    _need(counts, "counts", torch.int32, (nt,), dev)
    if dev.type != "cuda":
        return overhead_plain(kind, packed, planes, corder, counts, tile)
    if packed.data_ptr() % 16:
        raise ValueError("packed: the bulk copies need a 16-byte aligned base")
    out = torch.empty((nt, tile), dtype=torch.float32, device=dev)
    err = load_library().pbrt_overhead_probe(KINDS.index(kind), _ptr(packed), _ptr(planes),
                                             _ptr(corder), _ptr(counts), _ptr(out), nt,
                                             tile, cpad, n5, k, _stream(planes))
    if err:
        raise RuntimeError(f"overhead probe launch failed: cudaError {err}")
    overhead.launches += 1
    return out


overhead.launches = 0


def overhead_inputs(count, device, nt=NT, tile=TILE, n5=N5, seed=0, c=C, cpad=CPAD):
    """The probe's inputs from a numpy seed (not ones, so a wrong address
    shows): packed features in [-1, 1), ray planes in [-1, 1), per-tile
    random cluster orders, `count` clusters per tile."""
    r = np.random.RandomState(seed)
    packed = (r.rand(c, NFEAT, n5, K) * 2 - 1).astype(np.float32)
    planes = (r.rand(8, nt * tile) * 2 - 1).astype(np.float32)
    corder = r.randint(0, c, (nt, cpad)).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=device)   # noqa: E731
    return (t(packed), t(planes), t(corder),
            torch.full((nt,), count, dtype=torch.int32, device=device))


def overhead_ops(kind, count, nt=NT, tile=TILE, n5=N5, k=K):
    """f32 operations of one launch: 32 per (lane, slot) for stage+compute
    (16 products, 15 sums, one min), one sum per lane and round for stage."""
    rounds = nt * ((count + CH - 1) // CH)
    return {"empty": 0, "stage": rounds * tile,
            "stage+compute": rounds * tile * CH * n5 * k * 32}[kind]


def overhead_ceiling_ops(kind, count, nt=NT, tile=TILE, n5=N5, k=K):
    """Twice `overhead_ops`: the count whose time at the 67 TFLOP/s rate is
    the issue ceiling of bit-exact arithmetic. That rate counts a fused
    multiply-add as two operations; built with -fmad=false (for bit parity
    with the plain version), each product and each sum issues on its own,
    32 instructions a (lane, slot) where fused arithmetic would issue 16."""
    return 2 * overhead_ops(kind, count, nt, tile, n5, k)


def overhead_bytes(kind, count, nt=NT, tile=TILE, n5=N5, k=K):
    """Bytes one launch must move: its inputs read once, its output
    written once (packed only where staged)."""
    out = nt * tile * 4
    if kind == "empty":
        return 2 * out
    return out + 8 * nt * tile * 4 + nt * CPAD * 4 + nt * 4 + C * NFEAT * n5 * k * 4


def run(kind, count, n5=N5, reps=5):
    """µs per tile of one launch of the probe at its shapes, by CUDA events."""
    args = overhead_inputs(count, "cuda", n5=n5)
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
    for n5 in (N5, 1):
        for kind in KINDS:
            for count in ((0,) if kind == "empty" else COUNTS):
                us = run(kind, count, n5)
                print(f"n5={n5} {kind:14s} counts={count:3d} "
                      f"rounds={NT * ((count + CH - 1) // CH):6d} "
                      f"{us * NT / 1e3:8.3f} ms {us:8.3f} us/tile", flush=True)


if __name__ == "__main__":
    main()
