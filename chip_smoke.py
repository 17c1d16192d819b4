#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. the CUDA kernel build (kernels/csrc/cluster.cu, nvcc, ctypes);
  3. the bench scene (81,928 triangles at subdivisions=6);
  4a. every sampler kind's sample_1d and sample_2d at dims 0, 5, 159, 160
     and 9000 on the card, equal (torch.equal) to the CPU's, at spp 16,
     48 and 1,024, the sample indices below spp and (but stratified's)
     977 and 0x01020304 above them;
  4. each kernel against its plain PyTorch version on the card, on the
     bench scene's primary rays and on one fused bounce wavefront (about
     20% dead lanes, half shadow lanes), the plain version on at most 32
     tiles: bit for bit in tnear and covbits, t, slot and barycentrics,
     with equal test counts; coverage runs its tests the data needs
     (word-box tests, then the columns of the words a lane enters), at
     most half of testing every pair; the closest-hit kernel runs exactly
     the slot tests the data needs, at most half of what the earlier
     kernel ran (PRIOR_SLOT_TESTS); kernel times by CUDA events;
  4b. the coverage and any-hit kernels against their plain versions
     (coverage bit for bit with equal test counts; exact occ, equal
     slot-test counts, at most half of the earlier run count) on the shadow
     wavefront that direct.li sends and on the first occlusion wavefront
     that ao.li sends, both recorded from a 512×512 frame;
  5. a 64×64 depth-5 path render through the kernels (card) and through
     the plain versions (CPU), held to the pixel check of
     tests/test_oracle.py;
  5b. the same for 64×64 direct-lighting and ambient-occlusion renders;
  6. the bench render, 512×512, depth 5, 1 spp, zerotwo, compact_from=1:
     one warm-up and two timed frames with the launch counts;
  6b. the bench scene at 512×512, 1 spp with direct lighting (strategy
     "one") and ambient occlusion (4 cosine samples), one warm-up and two
     timed frames each, with the launch counts per frame;
  8. the Cornell box of the baseline configs (one cluster, C = 1): the
     three tracing kernels against their plain versions on its primary,
     fused-bounce and direct-shadow wavefronts at 256×256, bit for bit
     with equal test counts;
  9. config 1: direct lighting, 64×64 at 4 spp, random sampler, for the
     point, area and env lights: the tracers on every wavefront a frame
     traces, against their plain versions on every tile (bit for bit,
     equal test counts); one warm-up and three timed frames with the
     launches, the card's image against the plain versions' on the CPU
     (the pixel check);
  10. config 2: path at depth 5 with the mirror and glass spheres,
     256×256 at 64 spp in wavefronts of scenes.CORNELL_SPP_BATCH samples,
     zerotwo, compact_from=1: the tracers on the six wavefronts its first
     batch traces, against their plain versions on every tile; one
     warm-up and two timed frames, 0 NaN, Mrays/s from rays_traced, the
     launches; then 16×16 at 4 spp on the card against the CPU (the
     pixel check);
  12. config 4 (volpath, the fog box, 512×512, 4 spp in one wavefront of
     1,048,576 lanes, depth 5): the tracers on every tile of the frame's
     primary launch and of its first fused launch (N extension + 2N
     shadow lanes) against their plain versions, bit for bit with equal
     test counts; two timed frames, 0 NaN, Mrays/s from rays_traced,
     launches 6/6/0 a frame; 16×16 on the card against the CPU (the pixel
     check);
  13. volpath on the bench scene in fog and on the smoke box (grid
     medium), 512×512, 1 spp: the tracers on the primary and the first
     fused launch of a frame against their plain versions (the bench on
     32 tiles spread over each, the smoke box on every tile); two timed
     frames each, launches 6/6/0, the tracking loops' mean steps; each
     at 16×16 against the CPU;
  14. Whitted on config 2's box, 256×256 at 16 spp in one wavefront,
     depth 5: the tracers on every tile of the first depth's closest-hit
     and any-hit launches against their plain versions; two timed
     frames, launches 5 closest and 5 any hit per light row a frame;
     16×16 against the CPU;
  11. sample_li and pdf_li_area_scene of all eight light kinds, and
     build_spatial, on the card against the CPU (allclose on every lane
     but the ill-conditioned ones, by a float64 rule: check_lights);
  15. baseline config 5, gradients: one Cornell training step
     (dist.sharding.make_train_step on one rank, the demo's perturbed kd
     and emit), path at depth 5 and direct lighting, 64×64, 2 spp: the
     tracers on every wavefront the step sends (path: a primary and five
     fused launches; direct: two closest-hit and one any-hit launch)
     against their plain versions on every tile, and the launches a step
     (6/6/0, 3/2/1); the backward pass launches no tracer;
  16. the same path step at 16×16 on the card and on the CPU: the loss
     and the kd and emit gradients at rtol GRAD_RTOL, atol GRAD_ATOL;
  17. on a one-rank NCCL group: diff.demo at 256×256, 4 spp, depth 5,
     zerotwo (20 steps of plain gradient descent at lr 4): the albedo
     error under 0.5× and the emission error under 0.6× their starting
     values, 6/6/0 launches a render;
  18. config 5 at the bench scene's width: 512×512, 1 spp, path at depth
     5, compact_from=1, the white walls' and the blob's kd and the
     light's emit perturbed; one warm-up and four timed steps, the loss
     falling at every step: forward, backward, update and step ms
     (medians), rays a step, Mrays/s fwd+bwd, peak memory, launches a step
     (6/6/0), the card's nvidia-smi line;
  19. BDPT on the bench scene, 512×512, 1 spp, depth 5, random sampler
     (262,144 camera and 262,144 light subpaths): every tracer launch of a
     frame (11 closest hit, 20 any hit) held to its plain version on 32
     tiles spread over it; the splat scatter timed on a frame's own inputs
     (its five t=1 strategies) and run twice to the same image; one
     warm-up and two timed frames, the launches 31/11/20 a frame;
  20. SPPM on the bench scene, 512×512, depth 5, 4 iterations of 262,144
     photons, the hash-grid gather: the first photon-pass launch held the
     same way; two timed frames, launches 80/60/20, photons dropped;
  21. MLT on config 2's box, 256×256, depth 5, 262,144 bootstrap samples,
     65,536 chains, 4 mutations a pixel: two timed frames, launches
     36/36/0 (six path.li calls of six closest-hit launches); every frame
     (the warm-up and the profiled one too) the same image, and the scan
     of the bootstrap luminances' cdf (sampling.prefix_sum) the same in 20
     runs and equal to the CPU's, timed beside torch's cumsum, whose
     differing runs are counted;
  22. path on config 2's box in the spectral mode, 256×256, 16 spp, depth
     5, 12 bins (four renders of 1,048,576 lanes): two timed frames,
     launches 24/24/0;
     phases 19–22 each print ms, rays and Mrays/s, one profiled frame's GPU
     launches, peak memory, 0 NaN and the card's nvidia-smi line;
  23. at 16×16 on the card against the plain versions on the CPU (the pixel
     check): BDPT on the area- and env-lit Cornell boxes and the fog box,
     SPPM (grid), MLT on the specular box, the spectral mode;
  7. the probe kernels (kernels/probes.py): the compaction probe at tiles
     256 and 1,024 against its plain version (val 0 and -0.0 on some
     lanes), its device time (torch.profiler) beside an empty kernel's;
     the overhead probe at n5 = 5 and 1, every kind and cluster count,
     each held bit for bit to its plain version on 8 tiles.
Then one JSON line with each kernel's numbers (coverage's for each of the
four wavefronts, with the bound of the tests needed and that of testing
every pair; the tracers' slot-test counts; the overhead probe's non-fused
issue ceiling beside its bound; the compaction probe's launch floor;
every kernel's registers and spill bytes from nvcc -Xptxas -v), the
nvidia-smi line, and
the last line {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line.
"""
import json
import subprocess
import sys
import threading
import time

T0 = time.perf_counter()
H100_F32_FLOPS = 67e12        # non-tensor-core float32 peak, H100 SXM at 700 W
H100_HBM_BYTES = 3.35e12      # HBM3 bytes/s, H100 SXM
PLAIN_TILES = 32              # tiles the plain versions are run on
# The slot tests that the earlier tracers (one block per tile, every slot
# of a round for every joining lane) ran on the same wavefronts: counts
# that depend on the data alone, the gate of phases 4 and 4b
PRIOR_SLOT_TESTS = {"fused_bounce": 544214016, "primary": 258545664,
                    "direct_shadow": 536334441, "ao": 246831052}


def log(phase, **kv):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: "
          + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of fn() by CUDA events, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def pick_tiles(nt, n_live_tiles, limit=PLAIN_TILES):
    """Up to `limit` tile ids spread over the live tiles (every live tile
    for None), plus the first dead tile (live tiles first, as the plain
    version expects)."""
    import numpy as np
    if limit is None:
        live = np.arange(n_live_tiles)
    else:
        live = np.unique(np.linspace(0, max(n_live_tiles - 1, 0),
                                     min(limit - 1, n_live_tiles)).astype(int))
    dead = [n_live_tiles] if n_live_tiles < nt else []
    return list(live) + dead, len(live)


def sub_rays(rays, sel, tile):
    import torch
    return rays.view(8, -1, tile)[:, torch.as_tensor(sel, device=rays.device)] \
        .reshape(8, -1).contiguous()


def check_coverage(kern, cs, rays, tile, tag, limit=PLAIN_TILES, timed=True):
    """Kernel vs plain coverage on a tile subset (`limit` tiles, None for
    every tile), with equal test counts; the kernel's run count on the
    whole wavefront against the flat count (every lane of a live tile
    against every column); returns numbers (times only if `timed`)."""
    import torch
    nt = rays.shape[1] // tile
    n_live = int((rays[7] > rays[6]).sum())
    nlt = (n_live + tile - 1) // tile
    nlt_t = torch.tensor([nlt], dtype=torch.int32, device=rays.device)
    run, needed, krun, kneeded, prun, pneeded = (
        torch.zeros(1, dtype=torch.int64, device=rays.device) for _ in range(6))
    tnear, covbits = kern.coverage(rays, cs.bounds, nlt_t, cs.n_clusters, tile,
                                   tests_run=run, tests_needed=needed)
    sel, n_sel_live = pick_tiles(nt, nlt, limit)
    rs = sub_rays(rays, sel, tile)
    nls = torch.tensor([n_sel_live], dtype=torch.int32, device=rays.device)
    tp, cp = kern.coverage_plain(rs, cs.bounds, nls, cs.n_clusters, tile,
                                 tests_run=prun, tests_needed=pneeded)
    kern.coverage(rs, cs.bounds, nls, cs.n_clusters, tile, tests_run=krun,
                  tests_needed=kneeded)
    ti = torch.as_tensor(sel, device=rays.device)
    bit_mismatch = int(torch.bitwise_xor(covbits[ti], cp).ne(0).sum())
    tn_k, tn_p = tnear[ti], tp
    tn_mismatch = int((tn_k != tn_p).sum())
    fin = torch.isfinite(tn_p)
    err = float((tn_k[fin] - tn_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    cpad = cs.bounds.shape[1]
    flat = nlt * tile * cpad
    log(f"coverage[{tag}]", tiles=nt, live_tiles=nlt, compared_tiles=len(sel),
        covbit_word_mismatches=bit_mismatch, tnear_mismatches=tn_mismatch,
        tests_run_subset_kernel=int(krun), tests_run_subset_plain=int(prun),
        tests_needed_subset_kernel=int(kneeded), tests_needed_subset_plain=int(pneeded),
        tests_run=int(run), tests_needed=int(needed), flat_tests=flat)
    if (bit_mismatch or tn_mismatch or int(krun) != int(prun)
            or int(kneeded) != int(pneeded) or int(run) != int(needed)):
        fail(f"coverage[{tag}]: kernel and plain version disagree")
    if 2 * int(run) > flat:
        fail(f"coverage[{tag}]: runs {int(run)} slab tests, more than half of the "
             f"{flat} of testing every pair")
    if not timed:
        return dict(tests_run=int(run), tests_needed=int(needed), max_abs_err=err)
    ms = cuda_ms(lambda: kern.coverage(rays, cs.bounds, nlt_t, cs.n_clusters, tile), 20)
    kms = cuda_ms(lambda: kern.coverage(rs, cs.bounds, nls, cs.n_clusters, tile), 20)
    pms = cuda_ms(lambda: kern.coverage_plain(rs, cs.bounds, nls, cs.n_clusters, tile), 3)
    # 4 mul/add + 5 min/max per axis, compare: 28 a slab test; the bound
    # counts the tests the data needs, the flat bound every pair
    nbytes = rays.numel() * 4 + cs.bounds.numel() * 4 + nt * cpad * 4 + covbits.numel() * 4
    return dict(ms=ms, subset_kernel_ms=kms, plain_ms=pms, plain_tiles=len(sel),
                ops=int(needed) * 28, flat_ops=flat * 28, bytes=nbytes, tiles=nt,
                live_tiles=nlt, tests_run=int(run), tests_needed=int(needed),
                flat_tests=flat, max_abs_err=err)


def check_closest(kern, clmod, cs, rays, flag, tile, tag, limit=PLAIN_TILES, timed=True):
    """Kernel vs plain closest hit on a tile subset (`limit` tiles, None
    for every tile); returns numbers (times only if `timed`)."""
    import torch
    nt = rays.shape[1] // tile
    corder, tnear, counts, covbits = clmod.tile_cluster_order(cs, rays, tile)
    tests, needed, ptests, pneeded, ktests, kneeded = (
        torch.zeros(1, dtype=torch.int64, device=rays.device) for _ in range(6))
    t, slot, bary = kern.closest(cs.packed, rays, flag, corder, tnear, counts, covbits,
                                 tile, slot_tests=tests, needed_tests=needed)
    n_live = int((rays[7] > rays[6]).sum())
    sel, _ = pick_tiles(nt, (n_live + tile - 1) // tile, limit)
    ti = torch.as_tensor(sel, device=rays.device)
    rs = sub_rays(rays, sel, tile)
    fs = None if flag is None else flag.view(-1, tile)[ti].reshape(-1).contiguous()
    args = (cs.packed, rs, fs, corder[ti].contiguous(), tnear[ti].contiguous(),
            counts[ti].contiguous(), covbits[ti].contiguous(), tile)
    tp, sp, bp = kern.closest_plain(*args, slot_tests=ptests, needed_tests=pneeded)
    kern.closest(*args, slot_tests=ktests, needed_tests=kneeded)
    sk, tk, bk = slot[ti], t[ti], bary[ti]
    same = sk == sp
    frac = float(same.float().mean())
    hit = same & (sk >= 0)
    t_bad = int((~torch.isclose(tk[hit], tp[hit], rtol=1e-6, atol=0)).sum())
    b_bad = int((~torch.isclose(bk.permute(0, 2, 1)[hit], bp.permute(0, 2, 1)[hit],
                                rtol=1e-6, atol=0)).sum())
    bits = lambda a: a.contiguous().view(torch.int32)   # noqa: E731
    exact = bool(torch.equal(sk, sp) and torch.equal(bits(tk), bits(tp))
                 and torch.equal(bits(bk), bits(bp)))
    err = max(float((tk[hit] - tp[hit]).abs().max()) if bool(hit.any()) else 0.0,
              float((bk.permute(0, 2, 1)[hit] - bp.permute(0, 2, 1)[hit]).abs().max())
              if bool(hit.any()) else 0.0)
    log(f"closest[{tag}]", tiles=nt, compared_tiles=len(sel),
        slot_agreement=f"{frac:.6f}", slot_mismatches=int((~same).sum()),
        t_mismatches=t_bad, bary_mismatches=b_bad, bit_exact=exact, max_abs_err=err,
        slot_tests_subset_kernel=int(ktests), slot_tests_subset_plain=int(ptests),
        needed_tests_subset_kernel=int(kneeded), needed_tests_subset_plain=int(pneeded),
        slot_tests=int(tests), needed_tests=int(needed))
    if (not exact or t_bad or b_bad or int(ktests) != int(ptests)
            or int(kneeded) != int(pneeded)):
        fail(f"closest[{tag}]: kernel and plain version disagree")
    prior = PRIOR_SLOT_TESTS.get(tag)
    if int(tests) != int(needed) or (prior is not None and int(tests) > prior // 2):
        fail(f"closest[{tag}]: runs {int(tests)} slot tests, needs {int(needed)}; "
             f"the earlier kernel ran {prior}")
    if not timed:
        return dict(slot_tests=int(tests), needed_tests=int(needed), max_abs_err=err)
    ms = cuda_ms(lambda: kern.closest(cs.packed, rays, flag, corder, tnear, counts,
                                      covbits, tile), 10)
    kms = cuda_ms(lambda: kern.closest(*args), 10)
    pms = cuda_ms(lambda: kern.closest_plain(*args), 1)
    # the bound counts the tests the function needs, not those the kernel runs
    ops = int(needed) * 49    # 44 mul/add of the slot test, 3 sign products, 2 min
    nbytes = (cs.packed.numel() * 4 + rays.numel() * 4 + corder.numel() * 8
              + covbits.numel() * 4 + nt * tile * 16)
    return dict(ms=ms, subset_kernel_ms=kms, plain_ms=pms, plain_tiles=len(sel),
                ops=ops, bytes=nbytes, tiles=nt, slot_tests=int(tests),
                needed_tests=int(needed), mean_count=float(counts.float().mean()),
                max_abs_err=err)


def bound(ops, nbytes):
    """(ms, what bounds it): the least time the card could take."""
    t_ops, t_bytes = ops / H100_F32_FLOPS, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_occluded(kern, clmod, cs, o, d, t_min, t_max, tile, tag, limit=PLAIN_TILES,
                   timed=True):
    """Any-hit kernel vs its plain version on a tile subset (`limit`
    tiles, None for every tile) of one wavefront; returns numbers (times
    only if `timed`)."""
    import torch
    _, rays, _ = clmod.prepare(cs, o, d, t_min, t_max, tile)
    nt = rays.shape[1] // tile
    corder, tnear, counts, covbits = clmod.tile_cluster_order(cs, rays, tile)
    tests, needed, ptests, pneeded, ktests, kneeded = (
        torch.zeros(1, dtype=torch.int64, device=rays.device) for _ in range(6))
    occ = kern.occluded(cs.packed, rays, corder, tnear, counts, covbits, tile,
                        slot_tests=tests, needed_tests=needed)
    n_live = int((rays[7] > rays[6]).sum())
    sel, _ = pick_tiles(nt, (n_live + tile - 1) // tile, limit)
    ti = torch.as_tensor(sel, device=rays.device)
    args = (cs.packed, sub_rays(rays, sel, tile), corder[ti].contiguous(),
            tnear[ti].contiguous(), counts[ti].contiguous(), covbits[ti].contiguous(), tile)
    occ_p = kern.occluded_plain(*args, slot_tests=ptests, needed_tests=pneeded)
    occ_k = kern.occluded(*args, slot_tests=ktests, needed_tests=kneeded)
    mism = int((occ[ti] != occ_p).sum())
    err = float((occ[ti].to(torch.float32) - occ_p.to(torch.float32)).abs().max())
    log(f"occluded[{tag}]", tiles=nt, live_lanes=n_live, compared_tiles=len(sel),
        occ_mismatches=mism, subset_rerun_mismatches=int((occ_k != occ_p).sum()),
        occluded_share=f"{float(occ.float().sum()) / max(n_live, 1):.4f}",
        slot_tests_subset_kernel=int(ktests), slot_tests_subset_plain=int(ptests),
        needed_tests_subset_kernel=int(kneeded), needed_tests_subset_plain=int(pneeded),
        slot_tests=int(tests), needed_tests=int(needed))
    if (mism or not torch.equal(occ_k, occ_p) or int(ktests) != int(ptests)
            or int(kneeded) != int(pneeded)):
        fail(f"occluded[{tag}]: kernel and plain version disagree")
    prior = PRIOR_SLOT_TESTS.get(tag)
    if prior is not None and int(tests) > prior // 2:
        fail(f"occluded[{tag}]: runs {int(tests)} slot tests; the earlier kernel ran {prior}")
    if not timed:
        return dict(slot_tests=int(tests), needed_tests=int(needed), max_abs_err=err)
    full = (cs.packed, rays, corder, tnear, counts, covbits, tile)
    ms = cuda_ms(lambda: kern.occluded(*full), 10)
    kms = cuda_ms(lambda: kern.occluded(*args), 10)
    pms = cuda_ms(lambda: kern.occluded_plain(*args), 1)
    # the bound counts the tests the function needs, not those the kernel runs
    ops = int(needed) * 51    # the 49 of the slot test, two window compares
    nbytes = (cs.packed.numel() * 4 + rays.numel() * 4 + corder.numel() * 4
              + counts.numel() * 4 + covbits.numel() * 4 + nt * tile)
    return dict(ms=ms, subset_kernel_ms=kms, plain_ms=pms, plain_tiles=len(sel),
                ops=ops, bytes=nbytes, tiles=nt, slot_tests=int(tests),
                needed_tests=int(needed), max_abs_err=err)


def sent_wavefronts(clmod, run):
    """The wavefronts run() sends through geom.cluster, in order: ("closest",
    (o, d, t_min, t_max, flag)) for each closest-hit trace (intersect and
    the fused intersect_occluded; flag None or the shadow lanes' marks) and
    ("occluded", (o, d, t_min, t_max)) for each any-hit query. The
    wavefronts an integrator really traces."""
    real_trace, real_occ, sent = clmod._trace, clmod.occluded, []

    def trace(cs, o, d, t_min, t_max, tile, flag=None):
        sent.append(("closest", (o, d, t_min, t_max, flag)))
        return real_trace(cs, o, d, t_min, t_max, tile, flag)

    def occluded(cs, o, d, t_min, t_max, tile):
        sent.append(("occluded", (o, d, t_min, t_max)))
        return real_occ(cs, o, d, t_min, t_max, tile)

    clmod._trace, clmod.occluded = trace, occluded
    try:
        run()
    finally:
        clmod._trace, clmod.occluded = real_trace, real_occ
    return sent


def any_hit_queries(sent):
    """The (o, d, t_min, t_max) of the any-hit queries among `sent`."""
    return [w for kind, w in sent if kind == "occluded"]


def check_sent(kern, clmod, cs, sent, tile, tag, limit=None):
    """Coverage and the tracer of each wavefront in `sent` against their
    plain versions on `limit` tiles spread over it (None: every tile), bit
    for bit with equal test counts (the gates of check_coverage,
    check_closest and check_occluded). Returns the shapes held: [(kind,
    lanes, tiles)]."""
    held = []
    for i, (kind, w) in enumerate(sent):
        t = f"{tag}_{i}_{kind}"
        if kind == "closest":
            o, d, t_min, t_max, flag = w
            _, rays, flag_s = clmod.prepare(cs, o, d, t_min, t_max, tile, flag)
            check_coverage(kern, cs, rays, tile, t, limit=limit, timed=False)
            check_closest(kern, clmod, cs, rays, flag_s, tile, t, limit=limit, timed=False)
        else:
            rays = clmod.prepare(cs, *w, tile)[1]
            check_coverage(kern, cs, rays, tile, t, limit=limit, timed=False)
            check_occluded(kern, clmod, cs, *w, tile, t, limit=limit, timed=False)
        held.append((kind, int(w[0].shape[0]), rays.shape[1] // tile))
    return held


def device_ms(fn, reps, match=None):
    """Mean device milliseconds per call of fn(), from torch.profiler: the
    summed durations of the GPU kernels that `reps` calls launched (those
    whose names hold `match`, if given), after one warm-up. The kernels'
    own time on the card, not the host's rate of issuing them. None, with
    a log line, when the profiler did not record every launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and (match is None or match in e.name)]
    if not ev or (match is not None and len(ev) != reps):
        names = sorted({e.name[:60] for e in prof.events()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        log("profiler_missed", match=match, recorded=len(ev), calls=reps, device_events=names)
        return None
    return sum(e.device_time_total for e in ev) / reps / 1e3


def graph_ms(fn, n=100, reps=5, counted=None):
    """Milliseconds a call of fn() in a CUDA graph of n calls, by CUDA
    events around REPS replays: back-to-back launches on the card, the
    host's issue taken out. `counted`, the wrapper fn() calls, keeps the
    count of its kernel's launches that ran: the capture records n calls
    and runs none, each replay runs them."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    before = counted.launches if counted else 0
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    if counted:
        recorded, counted.launches = counted.launches - before, before
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    if counted:
        counted.launches += recorded * (1 + reps)
    return a.elapsed_time(b) / reps / n


def check_probes(probes):
    """Phase 7: both probes against their plain versions; the compaction
    probe's device time beside an empty kernel's; the overhead probe's ms
    for each n5, kind and cluster count."""
    import torch
    c_err = o_err = 0.0
    for tile in (256, 1024):
        mask, val = probes.compact_inputs(tile, "cuda", zeros=True)
        out, slot = probes.compact(mask, val)
        pout, pslot = probes.compact_plain(mask, val)
        ok = torch.equal(out.view(torch.int32), pout.view(torch.int32)) and \
            torch.equal(slot, pslot)
        c_err = max(c_err, float((out - pout).abs().max()),
                    float((slot - pslot).abs().max()))
        log("probe_compact", tile=tile, set_lanes=int(mask.sum()), equal=ok)
        if not ok:
            fail(f"compaction probe at tile {tile} disagrees with its plain version")
    # device times: the profiler's kernel durations where it recorded every
    # launch, else the time a launch in a CUDA graph of 100 (both printed)
    compact = dict(max_abs_err=c_err,
                   host_loop_ms=cuda_ms(lambda: probes.compact(mask, val), 100))
    for key, fn, match, counted in (
            ("ms", lambda: probes.compact(mask, val), "compact_probe_kernel", probes.compact),
            ("launch_floor_ms", lambda: probes.launch_floor(mask.device), "launch_floor_kernel",
             None),
            ("plain_ms", lambda: probes.compact_plain(mask, val), None, None)):
        compact[f"profiler_{key}"] = device_ms(fn, 100, match)
        compact[f"graph_{key}"] = graph_ms(fn, counted=counted)
        compact[key] = compact[f"profiler_{key}"] or compact[f"graph_{key}"]
    log("probe_compact_time", tile=1024, **compact)
    sub, over, held = 8, {}, {}
    for n5 in (probes.N5, 1):
        for kind in probes.KINDS:
            for count in ((0,) if kind == "empty" else probes.COUNTS):
                args = probes.overhead_inputs(count, "cuda", n5=n5)
                out = probes.overhead(kind, *args, probes.TILE)
                # held to its plain version on `sub` tiles
                packed, planes, corder, counts = args
                small = (packed, planes.view(8, -1, probes.TILE)[:, :sub].reshape(8, -1)
                         .contiguous(), corder[:sub].contiguous(), counts[:sub].contiguous())
                plain = probes.overhead_plain(kind, *small, probes.TILE)
                o_err = max(o_err, float((out[:sub] - plain).abs().max()))
                if not torch.equal(out[:sub].view(torch.int32), plain.view(torch.int32)):
                    fail(f"overhead probe n5={n5} {kind} counts={count} disagrees with its "
                         "plain version")
                if kind == "stage+compute" and count == probes.COUNTS[-1]:
                    held[n5] = dict(
                        plain_ms=cuda_ms(lambda: probes.overhead_plain(kind, *small,
                                                                       probes.TILE), 1),
                        subset_kernel_ms=cuda_ms(lambda: probes.overhead(kind, *small,
                                                                         probes.TILE), 5))
                ms = cuda_ms(lambda: probes.overhead(kind, *args, probes.TILE), 5)
                over[(n5, kind, count)] = ms
                log("probe_overhead", n5=n5, kind=kind, counts=count, ms=f"{ms:.4f}",
                    us_per_tile=f"{ms * 1e3 / probes.NT:.4f}", plain_tiles_equal=True)
    return dict(compact=compact, overhead=over, overhead_held=held,
                overhead_max_abs_err=o_err, plain_tiles=sub)


def bounce_wavefront(scene, o, d, hit, seed=1):
    """One fused bounce wavefront from primary hits: cosine-ish extension
    rays and shadow rays to random points on the light, about 20% of each
    marked dead (the path integrator's layout: extension lanes, then
    shadow lanes)."""
    import numpy as np
    import torch
    from pbrt_tpu_torch.core import vecmath as vm
    n = o.shape[0]
    dev = o.device
    r = np.random.RandomState(seed)
    u = torch.as_tensor(r.randn(n, 3).astype(np.float32), device=dev)
    wi = vm.normalize(hit.ns + vm.normalize(u))
    o_e = vm.offset_ray_origin(hit.p, hit.ng, wi)
    lp = scene.lights.em_tri_p[0].reshape(-1, 3).mean(0)
    jit = torch.as_tensor(((r.rand(n, 3) - 0.5) * 0.4).astype(np.float32), device=dev)
    to_l = lp + jit * torch.tensor([1.0, 0.0, 1.0], device=dev) - hit.p
    dist = vm.length(to_l)
    d_s = to_l / dist[:, None]
    o_s = vm.offset_ray_origin(hit.p, hit.ng, d_s)
    dead_e = torch.as_tensor(r.rand(n) < 0.2, device=dev) | ~hit.valid
    dead_s = torch.as_tensor(r.rand(n) < 0.2, device=dev) | ~hit.valid
    eps = 1e-4
    t_min = torch.full((2 * n,), eps, device=dev)
    t_max = torch.cat([torch.where(dead_e, -1.0, float("inf")),
                       torch.where(dead_s, -1.0, dist * (1.0 - 1e-3))])
    flag = torch.cat([torch.zeros(n, device=dev), torch.ones(n, device=dev)])
    return torch.cat([o_e, o_s]), torch.cat([wi, d_s]), t_min, t_max, flag


def pixel_check(img, ref, frac=0.995, tol=2e-3):
    """tests/test_oracle.py:_check: share of pixels within tol relative,
    and the mean difference."""
    import numpy as np
    diff = np.abs(img - ref)
    ok = (diff / np.maximum(np.abs(ref), 1e-2) < tol).all(-1)
    return float(ok.mean()), float(abs(img.mean() - ref.mean())), \
        bool(ok.mean() >= frac and abs(img.mean() - ref.mean()) < 1e-3)


def check_samplers(smp, pid, dev):
    """Every sampler kind's streams on the card equal the CPU's: the
    int64 uint32 emulation and true division (core/types.divisor). Each
    kind at spp 16, 48 and 1,024 with sample indices below spp (48: the
    stratum permutation's cycle walk), and every kind but stratified
    also at those indices plus 977 and plus 0x01020304, so that every
    byte of the Sobol' and max-min fold tables and Halton's higher
    digits are looked up."""
    import torch
    by_kind, cases = {}, 0
    for kind in smp.KINDS:
        same = True
        for spp in (16, 48, 1024):
            c = smp.SamplerConfig(kind=kind, spp=spp, seed=7)
            base = torch.remainder(pid * 7 + 3, spp)
            for off in ((0,) if kind == "stratified" else (0, 977, 0x01020304)):
                sid = base + off
                for fn in (smp.sample_1d, smp.sample_2d):
                    for dim in (0, 5, 159, 160, 9000):
                        same &= torch.equal(fn(c, pid, sid, dim).cpu(),
                                            fn(c, pid.cpu(), sid.cpu(), dim))
                        cases += 1
        by_kind[kind] = bool(same)
    log("sampler", lanes=pid.numel(), cases=cases, card_equals_cpu=all(by_kind.values()),
        **by_kind)
    if not all(by_kind.values()):
        fail(f"sampler streams differ between the card and the CPU: {by_kind}")


def timed_frames(fn, kernels, frames):
    """One warm-up call, then `frames` timed calls (host clock around
    synchronize) with the kernels' launches counted from 0. Returns
    (last result, ms per frame list, launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    times, out = [], None
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, times, {k: fn_.launches for k, fn_ in kernels.items()}


def to_float64(x):
    """x with every float32 tensor in it (dataclass and NamedTuple fields
    too) as float64."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.double() if x.dtype == torch.float32 else x
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: to_float64(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_float64(v) for v in x))
    return x


def check_lights(scenes_mod, lightsmod, distrib, dev):
    """sample_li and pdf_li_area_scene of all eight kinds, and
    build_spatial, on the card against the CPU at rtol 1e-4, atol 1e-6,
    on every lane of a field but its ill-conditioned ones. A lane is
    ill-conditioned in a field where float32 arithmetic on the CPU, at
    the lane's inputs or at inputs moved by up to 4 ulps (4 draws), lands
    outside that tolerance of a float64 evaluation at its inputs: a
    grazing sample (cos ≈ 0 flips li and the pdf), a sphere seen from far
    (1 − cos θmax cancels), an env sample near a pole. The rule reads the
    CPU alone, so a fault of the card's shows on every other lane."""
    import dataclasses
    import numpy as np
    import torch
    sc = {d: scenes_mod.with_all_light_kinds(scenes_mod.cornell_spheres(
        False, "area", d, clusters=False)) for d in (dev, "cpu")}
    c32 = sc["cpu"]
    c64 = dataclasses.replace(c32, lights=to_float64(c32.lights), quad=to_float64(c32.quad),
                              world_center=c32.world_center.double())
    r = np.random.RandomState(11)
    n = 1 << 16
    lt = r.randint(0, 8, n)
    p_ref = (r.rand(n, 3) * np.array([1.0, 1.0, -1.0])).astype(np.float32)
    u2 = r.rand(n, 2).astype(np.float32)
    p_hit = (r.rand(n, 3) * np.array([1.0, 1.0, -1.0])).astype(np.float32)
    ng = r.randn(n, 3).astype(np.float32)
    ng /= np.linalg.norm(ng, axis=-1, keepdims=True)

    def evaluate(s, d, pr, uu, ph, nn):
        T = lambda a: torch.as_tensor(a, device=d)   # noqa: E731
        ls = lightsmod.sample_li(s.lights, s, T(lt), T(pr), T(uu), s.world_radius)
        ls["pdf_li_area_scene"] = lightsmod.pdf_li_area_scene(s.lights, s, T(lt), T(pr),
                                                              T(ph), T(nn))
        return {k: v.cpu() for k, v in ls.items()}

    def outside(a, b):
        if a.dtype == torch.bool:
            off = a != b
        else:
            off = ~torch.isclose(a.double(), b.double(), rtol=1e-4, atol=1e-6)
        return off.reshape(n, -1).any(-1)

    inputs = (p_ref, u2, p_hit, ng)
    g = evaluate(sc[dev], dev, *inputs)
    c = evaluate(c32, "cpu", *inputs)
    ref = evaluate(c64, "cpu", *(a.astype(np.float64) for a in inputs))
    ill = {k: outside(c[k], ref[k]) for k in c}
    rp = np.random.RandomState(5)
    for _ in range(4):
        moved = [(a * (1.0 + rp.uniform(-4, 4, a.shape) * 2.0 ** -24)).astype(np.float32)
                 for a in inputs]
        moved[1] = np.clip(moved[1], 0.0, np.float32(1.0 - 2.0 ** -24))
        cm = evaluate(c32, "cpu", *moved)
        for k in ill:
            ill[k] |= outside(cm[k], ref[k])
    bad, off_all, off_well, n_ill = [], {}, {}, {}
    for k in g:
        off = outside(g[k], c[k])
        off_all[k], n_ill[k] = int(off.sum()), int(ill[k].sum())
        off_well[k] = int((off & ~ill[k]).sum())
        if off_well[k]:
            bad.append(k)
    kinds = sorted(set(c32.lights.kinds_present))
    sd_g = distrib.build_spatial(sc[dev], sc[dev].lights)
    sd_c = distrib.build_spatial(c32, c32.lights)
    sp_ok = torch.allclose(sd_g.grid_cdf.cpu(), sd_c.grid_cdf, rtol=1e-4, atol=1e-6)
    sp_err = float((sd_g.grid_cdf.cpu() - sd_c.grid_cdf).abs().max())
    log("lights", kinds=kinds, lanes=n, ill_conditioned_lanes=n_ill,
        lanes_outside_tol=off_all, outside_tol_well_conditioned=off_well, mismatched=bad,
        spatial_grid=tuple(sd_g.grid_cdf.shape), spatial_max_abs_err=f"{sp_err:.3e}",
        passed=not bad and sp_ok)
    if bad or not sp_ok or kinds != list(range(8)):
        fail(f"lights: the card disagrees with the CPU in {bad}, spatial {sp_ok}")


def cornell_phases(kern, clmod, scenemod, driver, direct, path, smp, dev, tile):
    """Phases 8–10, the Cornell box of the baseline configs: its
    one-cluster wavefronts through the three tracing kernels against
    their plain versions; config 1 (direct, 64×64, 4 spp) for the point,
    area and env lights; config 2 (path depth 5, specular spheres,
    256×256, 64 spp); before each config's timed frames, the tracers on
    every wavefront it traces (config 2: its first batch), every tile
    against the plain versions. Returns ({path tag: kernel launches},
    {path tag: frames})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.scenes import CORNELL_RES, CORNELL_SPP, CORNELL_SPP_BATCH
    kernels = {"coverage": kern.coverage, "closest": kern.closest,
               "occluded": kern.occluded}

    def hold_sent(tag, scene, run, want):
        """The tracers on every wavefront that run() sends through
        geom.cluster, each against its plain version on every tile; `want`
        the counts of closest-hit and any-hit wavefronts expected."""
        t0 = time.perf_counter()
        held = check_sent(kern, clmod, scene.clusters, sent_wavefronts(clmod, run), tile, tag)
        kinds = {k: sum(1 for h in held if h[0] == k) for k in ("closest", "occluded")}
        log(f"{tag}_wavefronts", held=held, seconds=f"{time.perf_counter() - t0:.2f}",
            all_tiles_equal=True)
        if kinds != want:
            fail(f"{tag}: traced {kinds} wavefronts, expected {want}")

    # 8. the tracers on the C = 1 wavefronts, bit for bit
    scene = scenes_mod.cornell_spheres(False, "area", dev)
    cs = scene.clusters
    log("cornell_scene", triangles=scene.tri.count, quadrics=scene.quad.count,
        clusters=cs.n_clusters, cpad=cs.bounds.shape[1], world_radius=scene.world_radius)
    if cs.n_clusters != 1:
        fail(f"the Cornell box should make one cluster, not {cs.n_clusters}")
    res = CORNELL_RES
    cam = scenes_mod.cornell_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = driver.lane_ids(cfg, 0, 1, dev)
    o, d, _, _ = driver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    n = o.shape[0]
    t_min = torch.full((n,), 1e-4, device=dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    _, rays_p, _ = clmod.prepare(cs, o, d, t_min, t_max, tile)
    check_coverage(kern, cs, rays_p, tile, "cornell_primary")
    check_closest(kern, clmod, cs, rays_p, None, tile, "cornell_primary")
    hit = scenemod.intersect(scene, o, d)
    ob, db, tminb, tmaxb, flag = bounce_wavefront(scene, o, d, hit)
    _, rays_b, flag_s = clmod.prepare(cs, ob, db, tminb, tmaxb, tile, flag)
    check_coverage(kern, cs, rays_b, tile, "cornell_fused_bounce")
    check_closest(kern, clmod, cs, rays_b, flag_s, tile, "cornell_fused_bounce")
    sent = any_hit_queries(sent_wavefronts(clmod, lambda: driver.render_lanes(
        scene, cam, cfg, direct.make_li(cfg, "one"), pid, sid)))
    if len(sent) != 1:
        fail(f"Cornell direct lighting sent {len(sent)} any-hit queries, expected 1")
    check_coverage(kern, cs, clmod.prepare(cs, *sent[0], tile)[1], tile, "cornell_shadow")
    check_occluded(kern, clmod, cs, *sent[0], tile, "cornell_shadow")
    torch.cuda.synchronize()

    by_path, frames_by = {}, {}
    # 9. config 1: direct lighting, 64×64, 4 spp, each light variant
    for light in ("point", "area", "env"):
        t0 = time.perf_counter()
        sg = scenes_mod.cornell_spheres(False, light, dev)
        sc = scenes_mod.cornell_spheres(False, light, "cpu")
        c1 = driver.RenderConfig(width=64, height=64, spp=4,
                                 sampler=smp.SamplerConfig(kind="random", spp=4))
        li = direct.make_li(c1, "one", return_stats=True)
        cam_g = scenes_mod.cornell_camera((64, 64), dev)
        hold_sent(f"cornell_config1_{light}", sg, lambda: driver.render(sg, cam_g, c1, li),
                  {"closest": 2, "occluded": 1})
        (img, stats), ms, launches = timed_frames(
            lambda: driver.render(sg, cam_g, c1, li), kernels, 3)
        img = img.cpu().numpy()
        ref = driver.render(sc, scenes_mod.cornell_camera((64, 64), "cpu"), c1,
                            direct.make_li(c1, "one")).numpy()
        frac, mdiff, ok = pixel_check(img, ref)
        rays = float(stats["rays_traced"])
        tag = f"cornell_config1_{light}"
        by_path[tag], frames_by[tag] = launches, 3
        per_frame = {k: v // 3 for k, v in launches.items()}
        log(tag, resolution="64x64", spp=4, integrator="direct", frame_ms=ms,
            mrays_per_s=f"{rays * 3 / sum(ms) / 1e3:.3f}", rays_per_frame=rays,
            launches_per_frame=per_frame, pixels_within_tol=f"{frac:.4f}",
            mean_diff=f"{mdiff:.3e}", mean=f"{img.mean():.6f}", nan=int(np.isnan(img).sum()),
            seconds=f"{time.perf_counter() - t0:.2f}", passed=ok)
        if not ok or not np.isfinite(img).all():
            fail(f"{tag}: the render through the kernels disagrees with the plain versions")
        if launches != {"coverage": 9, "closest": 6, "occluded": 3}:
            fail(f"{tag}: launches over 3 frames {launches}, expected 3/2/1 a frame")

    # 10. config 2: path depth 5, mirror and glass, 256×256 at 64 spp
    t0 = time.perf_counter()
    sg = scenes_mod.cornell_spheres(True, "area", dev)
    cam2 = scenes_mod.cornell_camera((res, res), dev)
    c2 = driver.RenderConfig(width=res, height=res, spp=CORNELL_SPP, max_depth=5,
                             sampler=smp.SamplerConfig(kind="zerotwo", spp=CORNELL_SPP),
                             samples_per_batch=CORNELL_SPP_BATCH)
    li = path.make_li(c2, camera=cam2, compact_from=1, return_stats=True)
    hold_sent("cornell_config2_batch0", sg,
              lambda: driver.render_batch(sg, cam2, c2, li, 0, CORNELL_SPP_BATCH),
              {"closest": 6, "occluded": 0})
    (img, stats), ms, launches = timed_frames(lambda: driver.render(sg, cam2, c2, li),
                                              kernels, 2)
    rays = float(stats["rays_traced"])
    n_nan = int(torch.isnan(img).sum())
    batches = CORNELL_SPP // CORNELL_SPP_BATCH
    by_path["cornell_config2"], frames_by["cornell_config2"] = launches, 2
    per_frame = {k: v // 2 for k, v in launches.items()}
    log("cornell_config2", resolution=f"{res}x{res}", spp=CORNELL_SPP, depth=5,
        integrator="path",
        samples_per_batch=CORNELL_SPP_BATCH, frame_ms=ms,
        mrays_per_s=f"{rays * 2 / sum(ms) / 1e3:.3f}", rays_per_frame=rays,
        launches_per_frame=per_frame, image_mean=f"{float(img.mean()):.6f}",
        nan=n_nan, seconds=f"{time.perf_counter() - t0:.2f}")
    if n_nan or not bool(torch.isfinite(img).all()) or tuple(img.shape) != (res, res, 3):
        fail("cornell_config2: image is not finite")
    if per_frame != {"coverage": 6 * batches, "closest": 6 * batches, "occluded": 0}:
        fail(f"cornell_config2: launches a frame {per_frame}")
    small = driver.RenderConfig(width=16, height=16, spp=4, max_depth=5,
                                sampler=smp.SamplerConfig(kind="zerotwo", spp=4))
    imgs = [driver.render(scenes_mod.cornell_spheres(True, "area", d),
                          scenes_mod.cornell_camera((16, 16), d), small,
                          path.make_li(small, camera=scenes_mod.cornell_camera((16, 16), d),
                                       compact_from=1)).cpu().numpy() for d in (dev, "cpu")]
    frac, mdiff, ok = pixel_check(*imgs)
    log("cornell_config2_16x16", pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
        mean=f"{imgs[0].mean():.6f}", passed=ok)
    if not ok:
        fail("cornell_config2_16x16: the render through the kernels disagrees with the plain "
             "versions")
    return by_path, frames_by


def volpath_phases(kern, clmod, driver, smp, dev, tile, kernels):
    """Phases 12–14, baseline config 4 and Whitted. Before each path's
    timed frames, the tracers on the wavefronts of one frame against their
    plain versions: volpath's primary and first fused (N extension + 2N
    shadow lanes) launch, Whitted's first depth (one closest-hit and one
    any-hit launch per light), every tile on the one-cluster boxes and
    PLAIN_TILES tiles spread over each on the bench scene. Config 4's fog
    box at 512×512, 4 spp in one wavefront, depth 5, two timed frames; the
    bench scene in fog at 512×512, 1 spp; the smoke box (grid medium) at
    512×512, 1 spp; Whitted on config 2's box at 256×256, 16 spp in one
    wavefront, depth 5; each at 16×16 against the plain versions on the
    CPU (the pixel check). Returns ({path tag: kernel launches}, {path
    tag: frames})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.integrate import volpath, whitted
    from pbrt_tpu_torch.shade import media as medmod
    by_path, frames_by = {}, {}

    def small_check(tag, make_scene, make_li, res, spp, make_cam=scenes_mod.cornell_camera):
        c = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                                sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
        imgs = [driver.render(make_scene(d), make_cam((res, res), d), c,
                              make_li(c)).cpu().numpy() for d in (dev, "cpu")]
        frac, mdiff, ok = pixel_check(*imgs)
        log(tag, pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
            mean=f"{imgs[0].mean():.6f}", passed=ok)
        if not ok or not np.isfinite(imgs[0]).all():
            fail(f"{tag}: the render through the kernels disagrees with the plain versions")

    def hold_frame(tag, scene, cam, cfg, li, want, first, limit=None):
        """One frame's wavefronts, in order: `want` the (kind, lanes, shadow
        lanes) of each; the first `first` held against the plain versions
        (on `limit` tiles spread over each, None for every tile)."""
        t0 = time.perf_counter()
        sent = sent_wavefronts(clmod, lambda: driver.render(scene, cam, cfg, li))
        shapes = [(k, int(w[0].shape[0]), None if k != "closest" or w[4] is None
                   else int(w[4].sum())) for k, w in sent]
        if shapes != want:
            fail(f"{tag}: traced {shapes}, expected {want}")
        held = check_sent(kern, clmod, scene.clusters, sent[:first], tile, tag, limit)
        del sent
        log(f"{tag}_wavefronts", held=held, compared_tiles_each=limit or "all",
            seconds=f"{time.perf_counter() - t0:.2f}", all_compared_equal=True)

    def frame_phase(tag, scene, cam, cfg, li, want, frames=2, extra=dict):
        t0 = time.perf_counter()
        (img, stats), ms, launches = timed_frames(lambda: driver.render(scene, cam, cfg, li),
                                                  kernels, frames)
        rays = float(stats["rays_traced"])
        n_nan = int(torch.isnan(img).sum())
        per_frame = {k: v // frames for k, v in launches.items()}
        by_path[tag], frames_by[tag] = launches, frames
        log(tag, resolution=f"{cfg.width}x{cfg.height}", spp=cfg.spp, depth=cfg.max_depth,
            lanes=cfg.width * cfg.height * cfg.spp, frame_ms=ms,
            mrays_per_s=f"{rays * frames / sum(ms) / 1e3:.3f}", rays_per_frame=rays,
            launches_per_frame=per_frame, image_mean=f"{float(img.mean()):.6f}", nan=n_nan,
            **extra(), seconds=f"{time.perf_counter() - t0:.2f}")
        if n_nan or not bool(torch.isfinite(img).all()) \
                or tuple(img.shape) != (cfg.height, cfg.width, 3):
            fail(f"{tag}: image is not finite")
        if per_frame != want or any(v % frames for v in launches.values()):
            fail(f"{tag}: launches over {frames} frames {launches}, expected {want} a frame")

    def volpath_shapes(cfg):
        """One primary launch of n lanes, five fused launches of n
        extension and 2n shadow lanes."""
        n = cfg.width * cfg.height * cfg.spp
        return [("closest", n, None)] + [("closest", 3 * n, 2 * n)] * 5

    six = {"coverage": 6, "closest": 6, "occluded": 0}
    # 12. config 4: the fog box
    res, spp = 512, 4
    fog = scenes_mod.fog_scene(device=dev)
    cam = scenes_mod.volumetric_camera((res, res), dev)
    c4 = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                             sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
    li4 = volpath.make_li(c4, return_stats=True)
    hold_frame("volpath_fog", fog, cam, c4, li4, volpath_shapes(c4), 2)
    frame_phase("volpath_fog", fog, cam, c4, li4, six)
    small_check("volpath_fog_16x16", lambda d: scenes_mod.fog_scene(device=d),
                lambda c: volpath.make_li(c), 16, 4)

    # 13. the bench scene in fog (702 clusters: a spread subset of tiles);
    # the smoke box (grid medium)
    c1 = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                             sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    bench_fog = scenes_mod.bench_fog_scene(6, dev)
    bcam = scenes_mod.bench_camera((res, res), dev)
    li1 = volpath.make_li(c1, return_stats=True)
    hold_frame("volpath_bench_fog", bench_fog, bcam, c1, li1, volpath_shapes(c1), 2,
               PLAIN_TILES)
    frame_phase("volpath_bench_fog", bench_fog, bcam, c1, li1, six)
    del bench_fog
    small_check("volpath_bench_fog_16x16", lambda d: scenes_mod.bench_fog_scene(6, d),
                lambda c: volpath.make_li(c), 16, 4, scenes_mod.bench_camera)
    smoke = scenes_mod.smoke_scene(device=dev)
    hold_frame("volpath_smoke", smoke, cam, c1, li1, volpath_shapes(c1), 2)
    steps0 = (medmod.TRACKED.steps, medmod.TRACKED.calls)

    def track_stats():
        steps = medmod.TRACKED.steps - steps0[0]
        calls = medmod.TRACKED.calls - steps0[1]
        return dict(tracking_calls=calls, tracking_mean_steps=f"{steps / max(calls, 1):.2f}")

    frame_phase("volpath_smoke", smoke, cam, c1, li1, six, extra=track_stats)
    small_check("volpath_smoke_16x16", lambda d: scenes_mod.smoke_scene(device=d),
                lambda c: volpath.make_li(c), 16, 2)

    # 14. Whitted on config 2's box, 256×256 at 16 spp in one wavefront
    wres, wspp = 256, 16
    box = scenes_mod.cornell_spheres(True, "area", dev)
    nl = box.lights.count
    wcam = scenes_mod.cornell_camera((wres, wres), dev)
    cw = driver.RenderConfig(width=wres, height=wres, spp=wspp, max_depth=5,
                             sampler=smp.SamplerConfig(kind="zerotwo", spp=wspp))
    lw = whitted.make_li(cw, return_stats=True)
    n = wres * wres * wspp
    hold_frame("whitted_cornell", box, wcam, cw, lw,
               ([("closest", n, None)] + [("occluded", n, None)] * nl) * 5, 1 + nl)
    frame_phase("whitted_cornell", box, wcam, cw, lw,
                {"coverage": 5 + 5 * nl, "closest": 5, "occluded": 5 * nl},
                extra=lambda: {"lights": nl})
    small_check("whitted_cornell_16x16", lambda d: scenes_mod.cornell_spheres(True, "area", d),
                lambda c: whitted.make_li(c), 16, 4)
    return by_path, frames_by


def gpu_launches(fn):
    """GPU kernels one call of fn() launches, counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def integrator_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line):
    """Phases 19–23: BDPT, SPPM, MLT and the spectral mode. BDPT on the
    bench scene (512×512, 1 spp, depth 5): every tracer launch of a frame
    held to its plain version on PLAIN_TILES tiles spread over it, the
    splat scatter timed on a frame's own inputs; SPPM on the bench scene
    (512×512, depth 5, 4 iterations of 262,144 photons, the grid gather):
    the first photon-pass launch held the same way; MLT on config 2's box
    (256×256, depth 5, 262,144 bootstrap samples, 65,536 chains, 4
    mutations a pixel: every frame the same image, its cdf scan repeatable
    and the CPU's); path on config 2's box in the spectral mode
    (256×256, 16 spp, depth 5, 12 bins: four renders of 1,048,576 lanes).
    Each: one warm-up and two timed frames (host clock around synchronize),
    the launches a frame exact, one profiled frame's GPU launches, 0 NaN,
    peak memory. Then each at 16×16 on the card against the plain
    versions on the CPU (the pixel check): BDPT on the area- and env-lit
    boxes and the fog box, SPPM, MLT and the spectral mode. Returns
    ({path: kernel launches}, {path: frames})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.film import film as filmmod
    from pbrt_tpu_torch.core.sampling import prefix_sum
    from pbrt_tpu_torch.integrate import bdpt, mlt, path, spectral, sppm
    by_path, frames_by = {}, {}

    def frame_phase(tag, key, frame, want, lanes, extra=None):
        """frame() → (image, stats); `want` the kernel launches a frame."""
        t0 = time.perf_counter()
        frames = 2
        torch.cuda.reset_peak_memory_stats()
        (img, stats), ms, launches = timed_frames(frame, kernels, frames)
        rays = float(stats["rays_traced"])
        n_gpu = gpu_launches(frame)
        per_frame = {k: v // frames for k, v in launches.items()}
        n_nan = int(torch.isnan(img).sum())
        by_path[key], frames_by[key] = launches, frames
        log(tag, lanes=lanes, frame_ms=[round(t, 3) for t in ms],
            rays_per_frame=rays, mrays_per_s=f"{rays * frames / sum(ms) / 1e3:.3f}",
            gpu_launches_per_frame=n_gpu, launches_per_frame=per_frame,
            peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            image_mean=f"{float(img.mean()):.6f}", nan=n_nan, card=f"'{smi_line}'",
            **(extra or {}), seconds=f"{time.perf_counter() - t0:.2f}")
        if n_nan or not bool(torch.isfinite(img).all()):
            fail(f"{tag}: image is not finite")
        if per_frame != want or any(v % frames for v in launches.values()):
            fail(f"{tag}: launches over {frames} frames {launches}, expected {want} a frame")

    def hold(tag, scene, run, want, first=None):
        """The wavefronts run() sends, in order: `want` their (kind, lanes);
        the first `first` (all for None) held on PLAIN_TILES tiles each."""
        t0 = time.perf_counter()
        sent = sent_wavefronts(clmod, run)
        shapes = [(k, int(w[0].shape[0])) for k, w in sent]
        if shapes != want:
            fail(f"{tag}: traced {shapes}, expected {want}")
        held = check_sent(kern, clmod, scene.clusters, sent[:first], tile, tag, PLAIN_TILES)
        del sent
        log(f"{tag}_wavefronts", held=held, compared_tiles_each=PLAIN_TILES,
            seconds=f"{time.perf_counter() - t0:.2f}", all_compared_equal=True)

    def parity(tag, make_scene, make_cam, render):
        """render(scene, camera) on the card and on the CPU, the pixel check."""
        t0 = time.perf_counter()
        imgs = [render(make_scene(d), make_cam((16, 16), d)).cpu().numpy()
                for d in (dev, "cpu")]
        frac, mdiff, ok = pixel_check(*imgs)
        log(tag, pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
            mean=f"{imgs[0].mean():.6f}", seconds=f"{time.perf_counter() - t0:.2f}",
            passed=ok)
        if not ok or not np.isfinite(imgs[0]).all() or imgs[0].mean() <= 0:
            fail(f"{tag}: the render through the kernels disagrees with the plain versions")

    res, mres, depth = 512, 256, 5     # the bench cells' width, config 2's box's, the depth
    n = res * res
    bench = scenes_mod.bench_scene(6, dev)
    bcam = scenes_mod.bench_camera((res, res), dev)

    # 19. BDPT on the bench scene: at depth 5, 6 + 5 walk steps (closest hit)
    # and 20 connections (any hit: 5 s=1, 10 s>=2 t>=2, 5 t=1)
    bcfg = bdpt.BDPTConfig(width=res, height=res, spp=1, max_depth=depth,
                           sampler=smp.SamplerConfig(kind="random", spp=1))
    n_conn = sum(1 for t in range(2, depth + 3) for s in range(1, depth + 2)
                 if s + t - 2 <= depth) + depth
    hold("bdpt_bench", bench, lambda: bdpt.render(bench, bcam, bcfg),
         [("closest", n)] * (2 * depth + 1) + [("occluded", n)] * n_conn)
    # the splat scatter on a frame's own inputs (its t=1 strategies), timed
    # and run twice
    splat_in, real_splat = [], filmmod.add_splats

    def record_splat(splats, pfilm, value, enabled=None):
        splat_in.append((pfilm, value, enabled))
        return real_splat(splats, pfilm, value, enabled)

    filmmod.add_splats = record_splat
    try:
        bdpt.render(bench, bcam, bcfg)
    finally:
        filmmod.add_splats = real_splat

    def splat_frame():
        out = torch.zeros((res, res, 3), device=dev)
        for args in splat_in:
            out = filmmod.add_splats(out, *args)
        return out

    splat_ms = cuda_ms(splat_frame, 10) / len(splat_in)
    same = torch.equal(splat_frame(), splat_frame())
    frame_phase("bdpt_bench", "bdpt", lambda: bdpt.render(bench, bcam, bcfg, return_stats=True),
                {"coverage": 2 * depth + 1 + n_conn, "closest": 2 * depth + 1,
                 "occluded": n_conn}, n,
                dict(splat_ms_per_call=f"{splat_ms:.4f}", splat_calls=len(splat_in),
                     splat_lanes=n, splat_repeatable=same))
    if not same:
        fail("bdpt_bench: the splat scatter gave two different images")

    # 20. SPPM on the bench scene, the grid gather; a photon pass is 5 closest-hit
    # launches, a camera pass 5 closest-hit and 5 (direct lighting) of each tracer
    scfg = sppm.SPPMConfig(width=res, height=res, n_iterations=4, photons_per_iter=n,
                           max_depth=depth, gather="auto", return_stats=True)
    if sppm.gather_method(scfg) != "grid":
        fail("sppm_bench: the gather should be the grid")
    hold("sppm_bench_photons", bench, lambda: sppm._photon_pass(bench, scfg, 0),
         [("closest", n)] * depth, first=1)
    dropped = {}

    def sppm_frame():
        img, stats = sppm.render(bench, bcam, scfg)
        dropped["n"] = stats["photons_dropped"]
        return img, stats

    frame_phase("sppm_bench", "sppm", sppm_frame,
                {"coverage": 16 * depth, "closest": 12 * depth, "occluded": 4 * depth}, n,
                dict(gather="grid", iterations=4, photons_per_iter=n))
    log("sppm_bench_photons_dropped", photons_dropped=dropped["n"],
        max_photons_per_cell=scfg.max_photons_per_cell)
    del bench

    # 21. MLT on config 2's box: path.li six closest-hit launches a call, one
    # bootstrap call, one for the seeded chains, one a mutation
    box = scenes_mod.cornell_spheres(True, "area", dev)
    mcam = scenes_mod.cornell_camera((mres, mres), dev)
    mcfg = mlt.MLTConfig(width=mres, height=mres, max_depth=depth, n_bootstrap=4 * mres * mres,
                         n_chains=mres * mres, mutations_per_pixel=4)
    mlt_imgs = []

    def mlt_frame():
        img, stats = mlt.render(box, mcam, mcfg, return_stats=True)
        mlt_imgs.append(img)
        return img, stats

    frame_phase("mlt_specular", "mlt", mlt_frame,
                {"coverage": (2 + 4) * (depth + 1), "closest": (2 + 4) * (depth + 1),
                 "occluded": 0}, mcfg.n_chains,
                dict(bootstrap=mcfg.n_bootstrap, chains=mcfg.n_chains, mutations=4))
    # every frame the same image; the scan behind the chains' seeding (the
    # bootstrap luminances' cdf) against torch's cumsum, each run 20 times
    row = torch.rand(mcfg.n_bootstrap + 1, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(21))

    def runs_differing(scan):
        first = scan(row)
        return sum(int(not torch.equal(scan(row), first)) for _ in range(20))

    same_frames = all(torch.equal(mlt_imgs[0], im) for im in mlt_imgs[1:])
    scan_differing = runs_differing(prefix_sum)
    scan_cpu = torch.equal(prefix_sum(row).cpu(), prefix_sum(row.cpu()))
    log("mlt_specular_repeatable", frames=len(mlt_imgs), images_equal=same_frames,
        scan_n=row.numel(), scan_runs_differing=scan_differing, scan_card_equals_cpu=scan_cpu,
        scan_ms=f"{cuda_ms(lambda: prefix_sum(row), 20):.4f}",
        cumsum_runs_differing=runs_differing(lambda x: torch.cumsum(x, -1)),
        cumsum_ms=f"{cuda_ms(lambda: torch.cumsum(row, -1), 20):.4f}")
    if not same_frames or scan_differing or not scan_cpu:
        fail("mlt_specular: frames or the cdf scan differ from run to run, or the scan from the CPU's")
    del mlt_imgs

    # 22. the spectral mode: path on config 2's box, four renders of three bins
    spp = 16
    pcfg = driver.RenderConfig(width=mres, height=mres, spp=spp, max_depth=depth,
                               sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))

    def spectral_frame():
        _, rgb, stats = spectral.render_spectral(
            box, mcam, pcfg, lambda c: path.make_li(c, camera=mcam, compact_from=1,
                                                    return_stats=True), 12)
        return rgb, stats

    frame_phase("spectral_cornell", "spectral", spectral_frame,
                {"coverage": 4 * (depth + 1), "closest": 4 * (depth + 1), "occluded": 0},
                mres * mres * spp,
                dict(bins=12, renders=4))
    del box

    # 23. 16×16: the card against the plain versions on the CPU
    c16 = bdpt.BDPTConfig(width=16, height=16, spp=4, max_depth=depth,
                          sampler=smp.SamplerConfig(kind="random", spp=4))
    for light in ("area", "env"):
        parity(f"bdpt_cornell_{light}_16x16",
               lambda d, light=light: scenes_mod.cornell_spheres(False, light, d),
               scenes_mod.cornell_camera, lambda s, c: bdpt.render(s, c, c16))
    parity("bdpt_fog_16x16", lambda d: scenes_mod.fog_scene(device=d),
           scenes_mod.volumetric_camera, lambda s, c: bdpt.render(s, c, c16))
    s16 = sppm.SPPMConfig(width=16, height=16, n_iterations=2, photons_per_iter=4096,
                          max_depth=depth, gather="grid")
    parity("sppm_cornell_16x16", lambda d: scenes_mod.cornell_spheres(False, "area", d),
           scenes_mod.cornell_camera, lambda s, c: sppm.render(s, c, s16))
    m16 = mlt.MLTConfig(width=16, height=16, max_depth=depth, n_bootstrap=4096, n_chains=256,
                        mutations_per_pixel=4)
    parity("mlt_specular_16x16", lambda d: scenes_mod.cornell_spheres(True, "area", d),
           scenes_mod.cornell_camera, lambda s, c: mlt.render(s, c, m16))
    p16 = driver.RenderConfig(width=16, height=16, spp=4, max_depth=depth,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=4))
    parity("spectral_cornell_16x16", lambda d: scenes_mod.cornell_spheres(True, "area", d),
           scenes_mod.cornell_camera,
           lambda s, c: spectral.render_spectral(s, c, p16, path.make_li, 12)[1])
    return by_path, frames_by


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The card's gradients against the plain versions' on the CPU: the tracers
# agree bit for bit, the rest rounds differently by an ulp or two (the
# card's transcendentals, reduction order); measured 1.6e-6 relative at
# most (H100, 16x16, 2 spp, depth 5), no sampling decision flipping
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def grad_phases(kern, clmod, driver, smp, dev, tile, kernels):
    """Phases 15–18, baseline config 5 (inverse rendering): gradients by
    path replay on torch.autograd, the tracers on detached rays, a
    one-rank NCCL group for the sharded steps. Returns ({path tag: kernel
    launches}, {path tag: steps})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.diff import demo
    from pbrt_tpu_torch.dist import multihost, sharding
    from pbrt_tpu_torch.integrate import direct, path
    by_path, steps_by = {}, {}

    def counts():
        return {k: fn.launches for k, fn in kernels.items()}

    def cornell_step(d, res, spp, integrator):
        """The demo's training step on device d, one rank: (step,
        perturbed scene, camera, target)."""
        cam = scenes_mod.cornell_camera((res, res), d)
        cfg = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                                  sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
        li = (path.make_li(cfg) if integrator == "path" else direct.make_li(cfg, "one"))
        step, bad, target = demo.training(scenes_mod.cornell_spheres(device=d), cam, cfg, li,
                                          demo.perturbed, sharding.make_mesh(1))
        return step, bad, cam, target

    # 15. the tracers on every wavefront a training step sends (path and
    # direct, 64×64, 2 spp), every tile against the plain versions
    for integrator, want, per_step in (
            ("path", {"closest": 6, "occluded": 0}, {"coverage": 6, "closest": 6, "occluded": 0}),
            ("direct", {"closest": 2, "occluded": 1},
             {"coverage": 3, "closest": 2, "occluded": 1})):
        t0 = time.perf_counter()
        step, bad, cam, target = cornell_step(dev, 64, 2, integrator)
        zero_launches(kernels)
        sent = sent_wavefronts(clmod, lambda: step(bad, cam, target, 4.0))
        tag = f"grad_wavefronts_{integrator}"
        by_path[tag], steps_by[tag] = counts(), 1
        held = check_sent(kern, clmod, bad.clusters, sent, tile, tag)
        kinds = {k: sum(1 for h in held if h[0] == k) for k in ("closest", "occluded")}
        log(tag, held=held, launches_per_step=by_path[tag],
            seconds=f"{time.perf_counter() - t0:.2f}", all_tiles_equal=True)
        if kinds != want or by_path[tag] != per_step:
            fail(f"{tag}: a training step traced {kinds} wavefronts, expected {want}; "
                 f"launches {by_path[tag]}, expected {per_step}")

    # 16. the same step's gradients on the card and on the CPU, 16×16
    t0 = time.perf_counter()
    got = {}
    for d in (dev, "cpu"):
        step, bad, cam, target = cornell_step(d, 16, 2, "path")
        loss, params, _ = step.forward(bad, cam, target)
        grads = step.backward(loss, params)
        got[str(d)] = (float(loss.detach()), {k: v.detach().cpu().numpy() for k, v in grads.items()})
    (lg, gg), (lc, gc) = got[str(dev)], got["cpu"]
    rel = {k: float(np.max(np.abs(gg[k] - gc[k]) / np.maximum(np.abs(gc[k]), 1e-12)))
           for k in gg}
    ok = all(np.allclose(gg[k], gc[k], rtol=GRAD_RTOL, atol=GRAD_ATOL) for k in gg) \
        and abs(lg - lc) <= GRAD_RTOL * abs(lc) and all(np.isfinite(v).all() for v in gg.values())
    log("grad_cpu_parity", resolution="16x16", spp=2, depth=5, loss_card=f"{lg:.9g}",
        loss_cpu=f"{lc:.9g}", max_rel_diff=rel, rtol=GRAD_RTOL, atol=GRAD_ATOL,
        kd_grad_card=np.round(gg["kd"], 6).tolist(), emit_grad_card=gg["emit"].tolist(),
        seconds=f"{time.perf_counter() - t0:.2f}", passed=ok)
    if not ok:
        fail("grad_cpu_parity: the card's gradients disagree with the plain versions'")

    multihost.ensure_initialized(f"127.0.0.1:{free_port()}", 1, 0, dev)
    try:
        mesh = sharding.make_mesh()
        backend = sharding.BACKEND[dev.type]
        if not mesh.grouped or torch.distributed.get_backend() != backend:
            fail(f"inverse phases: no {backend} process group")
        # 17. the config-5 demo at 256×256, 4 spp, depth 5, one NCCL rank
        t0 = time.perf_counter()
        zero_launches(kernels)
        out = demo.run(size=256, depth=5, device=dev, mesh=mesh, log=None)
        torch.cuda.synchronize()
        renders = demo.STEPS + 1          # the target, then one forward a step
        by_path["inverse_cornell"], steps_by["inverse_cornell"] = counts(), renders
        secs = time.perf_counter() - t0
        log("inverse_cornell", resolution="256x256", spp=demo.SPP, depth=5, steps=demo.STEPS,
            lr=demo.LR, ranks=mesh.size, backend=backend,
            albedo_err=f"{out['albedo_err0']:.4f}->{out['albedo_err1']:.4f}",
            emit_err=f"{out['emit_err0']:.4f}->{out['emit_err1']:.4f}",
            loss_first=f"{out['losses'][0]:.6f}", loss_last=f"{out['losses'][-1]:.6f}",
            launches=counts(), renders=renders, seconds=f"{secs:.2f}",
            ms_per_step=f"{secs * 1e3 / renders:.1f}", converged=out["converged"])
        if not out["converged"]:
            fail("inverse_cornell: the demo did not recover albedo and emission")
        if counts() != {"coverage": 6 * renders, "closest": 6 * renders, "occluded": 0}:
            fail(f"inverse_cornell: launches {counts()}, expected 6/6/0 a render")
        by_path["inverse_bench"], steps_by["inverse_bench"] = inverse_bench(
            driver, smp, dev, mesh, kernels)
    finally:
        multihost.shutdown()
    return by_path, steps_by


def zero_launches(kernels):
    for k in kernels.values():
        k.launches = 0


def inverse_bench(driver, smp, dev, mesh, kernels, steps=4):
    """Phase 18, config 5 at the bench scene's full width: 512×512, 1 spp,
    path at depth 5 with compact_from=1, the white walls' and the blob's
    kd and the quad light's emit perturbed; one warm-up and `steps` timed
    steps, each timed in its three parts (host clock around
    synchronize), the loss falling at every step. Returns (kernel
    launches over the timed steps, steps)."""
    import torch
    from pbrt_tpu_torch.diff import demo
    from pbrt_tpu_torch.integrate import path
    from pbrt_tpu_torch.scenes import bench_camera, bench_scene
    t0 = time.perf_counter()
    res = 512
    scene = bench_scene(6, dev)
    cam = bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)
    step, sc, target = demo.training(scene, cam, cfg, li, demo.perturbed_bench, mesh)
    lr = demo.LR

    def one(sc):
        """One step: (scene, loss, rays traced, (forward, backward, update,
        step) ms)."""
        torch.cuda.synchronize()
        a = time.perf_counter()
        loss, params, stats = step.forward(sc, cam, target)
        torch.cuda.synchronize()
        b = time.perf_counter()
        grads = step.backward(loss, params)
        torch.cuda.synchronize()
        c = time.perf_counter()
        sc = step.update(sc, params, grads, lr)
        total = float(step.total_loss(loss))
        torch.cuda.synchronize()
        e = time.perf_counter()
        return sc, total, float(stats["rays_traced"]), ((b - a) * 1e3, (c - b) * 1e3,
                                                       (e - c) * 1e3, (e - a) * 1e3)

    sc, loss, _, _ = one(sc)              # warm-up
    losses, times = [loss], []
    torch.cuda.reset_peak_memory_stats()
    zero_launches(kernels)
    for _ in range(steps):
        sc, loss, rays, t = one(sc)
        losses.append(loss)
        times.append(t)
    launches = {k: fn.launches for k, fn in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    fwd, bwd, upd, tot = (sorted(x)[len(x) // 2] for x in zip(*times))
    mrays = rays / ((fwd + bwd) / 1e3) / 1e6
    per_step = {k: v / steps for k, v in launches.items()}
    log("inverse_bench", resolution=f"{res}x{res}", spp=1, depth=5, compact_from=1,
        triangles=scene.tri.count, clusters=scene.clusters.n_clusters, lr=lr,
        ranks=mesh.size, losses=[round(x, 6) for x in losses],
        seconds=f"{time.perf_counter() - t0:.2f}")
    log("inverse_bench_ms", forward=f"{fwd:.3f}", backward=f"{bwd:.3f}", update=f"{upd:.3f}",
        step=f"{tot:.3f}", median_of=steps,
        all_steps=[[round(v, 3) for v in t] for t in times])
    log("inverse_bench_rays", rays_per_step=rays)
    log("inverse_bench_mrays_per_s_fwd_bwd", value=f"{mrays:.3f}")
    log("inverse_bench_peak_memory", bytes=peak, gib=f"{peak / 2**30:.3f}")
    log("inverse_bench_launches_per_step", **per_step)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log("inverse_bench_card", nvidia_smi=f"'{smi}'")
    if not all(losses[i + 1] < losses[i] for i in range(len(losses) - 1)):
        fail(f"inverse_bench: the loss did not fall at every step: {losses}")
    if per_step != {"coverage": 6, "closest": 6, "occluded": 0}:
        fail(f"inverse_bench: launches a step {per_step}, expected 6/6/0")
    return launches, steps


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    try:
        from pbrt_tpu_torch.kernels import cluster_cuda as kern
        from pbrt_tpu_torch.geom import cluster as clmod
        from pbrt_tpu_torch.geom import scene as scenemod
        from pbrt_tpu_torch.scenes import bench_scene, bench_camera
        from pbrt_tpu_torch.integrate import ao, direct, driver, path
        from pbrt_tpu_torch.kernels import probes
        from pbrt_tpu_torch.core import samplers as smp
    except ImportError as e:
        fail(f"pbrt_tpu_torch not importable here ({e}); run from the repository root")

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    smi_line = smi[0].strip() if smi else "nvidia-smi: no output"
    name = torch.cuda.get_device_name(0)
    log("card", nvidia_smi=f"'{smi_line}'", torch_device=f"'{name}'",
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. kernel build; registers and spills from a second nvcc beside it
    usage = {}
    ptxas = threading.Thread(target=lambda: usage.update(kern.resource_usage()))
    ptxas.start()
    t0 = time.perf_counter()
    kern.load_library()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=kern.build_seconds, library=kern.library_path())

    # 3. scene
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    scene = bench_scene(6, dev)
    cs = scene.clusters
    log("scene", triangles=scene.tri.count, clusters=cs.n_clusters,
        cpad=cs.bounds.shape[1], k=cs.cluster_size, seconds=f"{time.perf_counter() - t0:.2f}")

    # 4. kernels vs plain versions at the bench's widths
    res, tile = 512, scene.tile
    cam = bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = driver.lane_ids(cfg, 0, 1, dev)
    check_samplers(smp, pid.reshape(-1)[::4], dev)    # every fourth lane: 65,536
    o, d, _, _ = driver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    n = o.shape[0]
    t_min = torch.full((n,), 1e-4, device=dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    _, rays_p, _ = clmod.prepare(cs, o, d, t_min, t_max, tile)
    cov_p = check_coverage(kern, cs, rays_p, tile, "primary")
    cl_p = check_closest(kern, clmod, cs, rays_p, None, tile, "primary")
    hit = scenemod.intersect(scene, o, d)
    ob, db, tminb, tmaxb, flag = bounce_wavefront(scene, o, d, hit)
    _, rays_b, flag_s = clmod.prepare(cs, ob, db, tminb, tmaxb, tile, flag)
    cov_b = check_coverage(kern, cs, rays_b, tile, "fused_bounce")
    cl_b = check_closest(kern, clmod, cs, rays_b, flag_s, tile, "fused_bounce")
    torch.cuda.synchronize()

    # 4b. the any-hit kernel on the wavefronts direct.li and ao.li send
    sent_d = any_hit_queries(sent_wavefronts(clmod, lambda: driver.render_lanes(
        scene, cam, cfg, direct.make_li(cfg, "one"), pid, sid)))
    sent_a = any_hit_queries(sent_wavefronts(clmod, lambda: driver.render_lanes(
        scene, cam, cfg, ao.make_li(cfg, True, 4), pid, sid)))
    if (len(sent_d), len(sent_a)) != (1, 4):
        fail(f"any-hit queries sent: direct {len(sent_d)}, AO {len(sent_a)}; expected 1, 4")
    cov_d = check_coverage(kern, cs, clmod.prepare(cs, *sent_d[0], tile)[1], tile,
                           "direct_shadow")
    cov_a = check_coverage(kern, cs, clmod.prepare(cs, *sent_a[0], tile)[1], tile, "ao")
    oc_d = check_occluded(kern, clmod, cs, *sent_d[0], tile, "direct_shadow")
    oc_a = check_occluded(kern, clmod, cs, *sent_a[0], tile, "ao")
    torch.cuda.synchronize()

    # 5, 5b. 64×64 renders: kernels on the card vs plain versions on the CPU
    small = 64
    cfg_s = driver.RenderConfig(width=small, height=small, spp=1, max_depth=5,
                                sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    cam_g = bench_camera((small, small), dev)
    scene_c = bench_scene(6, "cpu")
    cam_c = bench_camera((small, small), "cpu")
    for tag, make in (
            ("render64", lambda cam: path.make_li(cfg_s, camera=cam, compact_from=1)),
            ("render64_direct", lambda cam: direct.make_li(cfg_s, "one")),
            ("render64_ao", lambda cam: ao.make_li(cfg_s, True, 4))):
        t0 = time.perf_counter()
        img_k = driver.render(scene, cam_g, cfg_s, make(cam_g)).cpu().numpy()
        img_p = driver.render(scene_c, cam_c, cfg_s, make(cam_c)).numpy()
        frac, mdiff, ok = pixel_check(img_k, img_p)
        log(tag, pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
            mean=f"{img_k.mean():.6f}", identical=bool(np.array_equal(img_k, img_p)),
            seconds=f"{time.perf_counter() - t0:.2f}", passed=ok)
        if not ok or not np.isfinite(img_k).all():
            fail(f"{tag}: the render through the kernels disagrees with the plain versions")

    # 6, 6b. the bench renders, each with its launches counted per frame
    kernels = {"coverage": kern.coverage, "closest": kern.closest,
               "occluded": kern.occluded}
    benches = (("bench", path.make_li(cfg, camera=cam, compact_from=1, return_stats=True),
                {"coverage": 6, "closest": 6, "occluded": 0}),
               ("bench_direct", direct.make_li(cfg, "one", return_stats=True),
                {"coverage": 3, "closest": 2, "occluded": 1}),
               ("bench_ao", ao.make_li(cfg, True, 4, return_stats=True),
                {"coverage": 5, "closest": 1, "occluded": 4}))
    frames, by_path, frames_by = 2, {}, {}
    for tag, li, per_frame in benches:
        def frame():
            return driver.render_lanes(scene, cam, cfg, li, pid, sid)[0]

        frame()
        torch.cuda.synchronize()
        for fn in kernels.values():
            fn.launches = 0
        times, img, stats = [], None, None
        for _ in range(frames):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img, stats = frame()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in kernels.items()}
        by_path[tag], frames_by[tag] = launches, frames
        img = img.reshape(res, res, 3)
        n_nan = int(torch.isnan(img).sum())
        rays = float(stats["rays_traced"])    # each integrator counts its own
        ms = [t * 1e3 for t in times]
        extra = {} if "occupancy" not in stats else {
            "occupancy": [round(float(x), 4) for x in stats["occupancy"]]}
        log(tag, resolution=f"{res}x{res}", spp=1, frame_ms=ms,
            mrays_per_s=f"{rays * frames / sum(times) / 1e6:.3f}", rays_per_frame=rays,
            **extra, image_mean=f"{float(img.mean()):.6f}", nan=n_nan, launches=launches)
        if n_nan or not bool(torch.isfinite(img).all()) or tuple(img.shape) != (res, res, 3):
            fail(f"{tag}: image is not finite")
        want = {k: v * frames for k, v in per_frame.items()}
        if launches != want:
            fail(f"{tag}: expected launches {want} over {frames} frames, got {launches}")

    # 8-10. the Cornell box; 11. the light table on the card
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.lights import distrib, lights as lightsmod
    for part in (cornell_phases(kern, clmod, scenemod, driver, direct, path, smp, dev, tile),
                 volpath_phases(kern, clmod, driver, smp, dev, tile, kernels),
                 grad_phases(kern, clmod, driver, smp, dev, tile, kernels),
                 integrator_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line)):
        by_path.update(part[0])
        frames_by.update(part[1])
    check_lights(scenes_mod, lightsmod, distrib, dev)

    # 7. the probes, their launches counted over this phase
    probes.compact.launches = probes.overhead.launches = 0
    pr = check_probes(probes)
    probe_launches = {"compact": probes.compact.launches,
                      "overhead": probes.overhead.launches}
    if not all(probe_launches.values()):
        fail(f"a probe kernel never launched: {probe_launches}")

    def total(name):
        return sum(v[name] for v in by_path.values())

    def row(name, replaces, c_primary, c, source="pbrt_tpu_torch/kernels/csrc/cluster.cu",
            **extra):
        bound_ms, by = bound(c["ops"], c["bytes"])
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=total(name),
                    max_abs_err=max(c_primary["max_abs_err"], c["max_abs_err"]),
                    ms=c["ms"], plain_ms=c["plain_ms"], bound_ms=bound_ms, bound_by=by,
                    library_ms=None,
                    launches_by_path={k: v[name] for k, v in by_path.items()},
                    launches_per_frame_by_path={k: v[name] // frames_by[k]
                                                for k, v in by_path.items()},
                    subset_kernel_ms=c["subset_kernel_ms"], plain_tiles=c["plain_tiles"],
                    **extra)

    ptxas.join()
    if not {"coverage_lanes_kernel", "coverage_columns_kernel", "closest_kernel",
            "occluded_kernel"} <= set(usage):
        fail(f"nvcc -Xptxas -v gave no register counts: {usage}")

    def resources(*knames):
        """Registers (the most of the kernels') and spill-store bytes (their
        sum), each kernel's beside them where there are several."""
        by = {k: usage[k] for k in knames}
        out = dict(registers=max(r for r, _ in by.values()),
                   spill_store_bytes=sum(b for _, b in by.values()))
        if len(knames) > 1:
            out["registers_by_kernel"] = {k: r for k, (r, _) in by.items()}
            out["spill_store_bytes_by_kernel"] = {k: b for k, (_, b) in by.items()}
        return out

    covs = {"primary": cov_p, "fused_bounce": cov_b, "direct_shadow": cov_d, "ao": cov_a}
    cov_row = row("coverage", "pbrt_tpu/kernels/cluster_pallas.py:303", cov_p, cov_b,
                  shape="fused_bounce",
                  ms_by_wavefront={k: c["ms"] for k, c in covs.items()},
                  bound_ms_by_wavefront={k: bound(c["ops"], c["bytes"])[0]
                                         for k, c in covs.items()},
                  bound_by_by_wavefront={k: bound(c["ops"], c["bytes"])[1]
                                         for k, c in covs.items()},
                  flat_bound_ms_by_wavefront={k: bound(c["flat_ops"], c["bytes"])[0]
                                              for k, c in covs.items()},
                  tests_run_by_wavefront={k: c["tests_run"] for k, c in covs.items()},
                  tests_needed_by_wavefront={k: c["tests_needed"] for k, c in covs.items()},
                  flat_tests_by_wavefront={k: c["flat_tests"] for k, c in covs.items()},
                  **resources("coverage_lanes_kernel", "coverage_columns_kernel"))
    cov_row["max_abs_err"] = max(c["max_abs_err"] for c in covs.values())
    rows = [cov_row,
            row("closest", "pbrt_tpu/kernels/cluster_pallas.py:876", cl_p, cl_b,
                shape="fused_bounce", primary_ms=cl_p["ms"],
                primary_bound_ms=bound(cl_p["ops"], cl_p["bytes"])[0],
                slot_tests=cl_b["slot_tests"], needed_tests=cl_b["needed_tests"],
                slot_tests_primary=cl_p["slot_tests"],
                needed_tests_primary=cl_p["needed_tests"],
                **resources("closest_kernel")),
            row("occluded", "pbrt_tpu/kernels/cluster_pallas.py:924", oc_d, oc_a,
                shape="ao", direct_shadow_ms=oc_d["ms"],
                direct_shadow_plain_ms=oc_d["plain_ms"],
                direct_shadow_bound_ms=bound(oc_d["ops"], oc_d["bytes"])[0],
                slot_tests=oc_a["slot_tests"], needed_tests=oc_a["needed_tests"],
                slot_tests_direct_shadow=oc_d["slot_tests"],
                needed_tests_direct_shadow=oc_d["needed_tests"],
                **resources("occluded_kernel"))]
    kind, count = "stage+compute", probes.COUNTS[-1]

    def overhead_bounds(n5):
        """(bound ms, bound by, non-fused issue ceiling ms) at the probe's shapes."""
        b_ms, by = bound(probes.overhead_ops(kind, count, n5=n5),
                         probes.overhead_bytes(kind, count, n5=n5))
        return b_ms, by, probes.overhead_ceiling_ops(kind, count, n5=n5) / H100_F32_FLOPS * 1e3

    o_bound, o_by, o_ceiling = overhead_bounds(probes.N5)
    o1_bound, _, o1_ceiling = overhead_bounds(1)
    rows.append(dict(name="overhead_probe", route="cuda",
                     source="pbrt_tpu_torch/kernels/csrc/cluster.cu",
                     replaces="profile_overhead.py:111", launches=probe_launches["overhead"],
                     max_abs_err=pr["overhead_max_abs_err"],
                     ms=pr["overhead"][(probes.N5, kind, count)],
                     plain_ms=pr["overhead_held"][probes.N5]["plain_ms"], bound_ms=o_bound,
                     bound_by=o_by, ceiling_ms=o_ceiling, library_ms=None,
                     shape=f"{kind} counts={count} n5={probes.N5}",
                     plain_tiles=pr["plain_tiles"],
                     subset_kernel_ms=pr["overhead_held"][probes.N5]["subset_kernel_ms"],
                     n5_1=dict(ms=pr["overhead"][(1, kind, count)], bound_ms=o1_bound,
                               ceiling_ms=o1_ceiling, **pr["overhead_held"][1]),
                     ms_by_shape={f"n5={n} {k} {c}": v
                                  for (n, k, c), v in pr["overhead"].items()},
                     **resources("overhead_probe_kernel")))
    c_bound, c_by = bound(0, 4 * 1024 * 4)     # mask, val in; out, slot out
    cp = pr["compact"]
    rows.append(dict(name="compact_probe", route="cuda",
                     source="pbrt_tpu_torch/kernels/csrc/cluster.cu",
                     replaces="debug_lc_prim2.py:89", launches=probe_launches["compact"],
                     max_abs_err=cp["max_abs_err"], ms=cp["ms"], plain_ms=cp["plain_ms"],
                     bound_ms=c_bound, bound_by=c_by, launch_floor_ms=cp["launch_floor_ms"],
                     library_ms=None,
                     shape="tile=1024; ms, plain_ms, launch_floor_ms: device time "
                           "(torch.profiler, else a launch in a CUDA graph of 100)",
                     **{k: v for k, v in cp.items() if k.startswith(("profiler_", "graph_"))},
                     host_loop_ms=cp["host_loop_ms"],
                     **resources("compact_probe_kernel")))
    print(json.dumps({"kernels": rows}), flush=True)
    log("done", total_seconds=f"{time.perf_counter() - T0:.1f}")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
