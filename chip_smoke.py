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
  24. path at depth 5, compact_from=1 on the bench scene with a metal blob
     and with a subsurface blob, 512×512, 1 spp: every wavefront of a
     frame (the subsurface probes' two windowed closest-hit launches and
     the exit's any-hit launch a bounce among them) held to its plain
     version on 32 tiles spread over it; two timed frames, launches 6/6/0
     (metal) and 21/16/5 (subsurface) a frame;
  25. the same on the appearance box (config 2's box with a surface of
     each material kind but mix, each texture kind and a bump-mapped back
     wall), 256×256 at 16 spp in one wavefront: launches 21/16/5;
     phases 24–25 print ms, rays and Mrays/s, one profiled frame's GPU
     launches, peak memory, 0 NaN and the card's nvidia-smi line;
  26. at 16×16 on the card against the plain versions on the CPU (the pixel
     check): path on the appearance box and on the subsurface bench,
     direct, volpath, BDPT (1 spp, depth 3) and SPPM on the box;
  27. the bench scene as a scene file: the blob written as a binary PLY
     (geom.meshio.write_ply) beside a .pbrt file of the room, its light and
     the bench camera, loaded by pbrt_loader.load_pbrt on the card (its
     triangles and normals bit for bit the blob's, the cluster set built),
     one path frame at 512×512, depth 5, with the file's sampler (zerotwo,
     1 spp): its primary and first fused wavefronts held to the plain
     versions on 32 tiles, launches 6/6/0; the image written by
     film.io.write_exr / write_pfm / write_npy / write_png and read back,
     the first three bit for bit;
  28. the loaded scene, one frame each at 512×512, its primary wavefront held
     on 32 tiles: thin lens + mitchell, orthographic + gaussian, environment +
     triangle and realistic (DEMO_LENS, its vignetted share) + lanczos
     through path (6/6/0), thin lens + mitchell through direct (3/2/1);
     phases 27–28 print ms, GPU launches, 0 NaN and the card's nvidia-smi line;
  29. the thin-lens mitchell path render at 16×16 on the card against the
     CPU (the pixel check; pixels whose filter weights sum to 0 or less
     held apart at rtol 1e-4);
  30. the instance field (scenes.instance_field: the bench room, 64
     instances of one 1,280-triangle Loop-subdivided prototype, 16 of them
     moving over the shutter, an emissive instance), path at depth 5, 512×512,
     1 spp, zerotwo, compact_from=1: every wavefront of the primary and the
     first fused trace (the scene pool's and each prototype's object-space
     pair wavefront) held to its plain version on 32 tiles; the tracer
     launches a frame those the recorded frame sent (the scene pool's 6/6/0,
     at most 6 of each more a prototype); one warm-up and two timed frames,
     ms, rays, Mrays/s, one profiled frame's GPU launches, peak memory,
     0 NaN; the field at 16×16 (n_side 3, 4 spp) against the CPU;
  31. the bench scene through geom/bvh.py in place of its clusters: the
     primary and one fused bounce wavefront at 512×512 against the cluster
     kernels (hits, triangles, t at rtol 1e-3), steps and ms; the kd-tree of
     bench_blob(4): build seconds, its primary hits against the brute force;
  32. config 1's 64×64 direct render (point and area light, random
     sampler, 4 spp) on the card against the port's oracle.render_direct
     (the pixel check);
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
# row gathers of kd and emit a Cornell training step, each one
# row_grad_kernel launch in its backward: path at depth 5 gathers kd at
# each of 5 shading bounces and emit 11 times (the light sample at each
# bounce, the hit light's radiance at each trace); direct, 1 and 3
ROW_GRADS_A_STEP = {"path": 16, "direct": 4}
# the instance field's tracer launches a frame: 6 traces (the primary and
# five fused bounces at depth 5), each one closest launch of the scene pool
# and one (intersect_flagged, closest and shadow pairs together) for each
# prototype whose pre-cull finds pairs; both prototypes find pairs in every
# trace of the 512×512 field
FIELD_PER_SET = {0: 6, 1: 6}
FIELD_LAUNCHES = {"coverage": 18, "closest": 18, "occluded": 0}
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
    return [(kind, w) for kind, _, w in sent_with_sets(clmod, run)]


def sent_with_sets(clmod, run, instmod=None):
    """As sent_wavefronts, each wavefront with the cluster set it was traced
    through (the scene's, or an instanced prototype's): [(kind, cs, w)].
    With `instmod` (geom.instances) each instance set's pre-cull is
    recorded in its place too, as ("pairs", iset, number of pairs)."""
    real_trace, real_occ, sent = clmod._trace, clmod.occluded, []
    real_pairs = instmod.pairs if instmod is not None else None

    def trace(cs, o, d, t_min, t_max, tile, flag=None):
        sent.append(("closest", cs, (o, d, t_min, t_max, flag)))
        return real_trace(cs, o, d, t_min, t_max, tile, flag)

    def occluded(cs, o, d, t_min, t_max, tile):
        sent.append(("occluded", cs, (o, d, t_min, t_max)))
        return real_occ(cs, o, d, t_min, t_max, tile)

    def pairs(iset, *rays):
        out = real_pairs(iset, *rays)
        sent.append(("pairs", iset, int(out[0].numel())))
        return out

    clmod._trace, clmod.occluded = trace, occluded
    if instmod is not None:
        instmod.pairs = pairs
    try:
        run()
    finally:
        clmod._trace, clmod.occluded = real_trace, real_occ
        if instmod is not None:
            instmod.pairs = real_pairs
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


def check_small(driver, smp, dev, tag, make_scene, make_li, res, spp, make_cam, filt=None):
    """A res×res render at `spp` (zerotwo, depth 5, the box filter or
    `filt`) through the kernels on `dev` against the plain versions on the
    CPU: the pixel check. Under a filter with negative lobes, a pixel whose
    weights sum to 0 or less is divided by 1e-10 (film.resolve, as the JAX
    package does): those pixels are held apart at rtol 1e-4."""
    import numpy as np
    kw = {} if filt is None else {"filter": filt}
    c = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=5,
                            sampler=smp.SamplerConfig(kind="zerotwo", spp=spp), **kw)
    imgs = [driver.render(make_scene(d), make_cam((res, res), d), c,
                          make_li(c)).cpu().numpy() for d in (dev, "cpu")]
    pid, sid = driver.lane_ids(c, 0, spp, "cpu")
    fw = driver.camera_rays(make_cam((res, res), "cpu"), c, pid, sid)[3]
    flat = (fw.sum(0) <= 0).reshape(res, res).numpy()
    frac, mdiff, ok = pixel_check(imgs[0][~flat], imgs[1][~flat])
    apart = bool(np.allclose(imgs[0][flat], imgs[1][flat], rtol=1e-4, atol=0))
    log(tag, pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
        mean=f"{imgs[0][~flat].mean():.6f}", nonpositive_weight_pixels=int(flat.sum()),
        those_within_rtol=apart, passed=ok and apart)
    if not ok or not apart or not np.isfinite(imgs[0]).all():
        fail(f"{tag}: the render through the kernels disagrees with the plain versions")


def hold_wavefronts(kern, clmod, driver, tile, tag, scene, cam, cfg, li, want, first,
                    limit=None):
    """One frame's wavefronts, in order: `want` the (kind, lanes, shadow
    lanes) of each; the first `first` held against the plain versions (on
    `limit` tiles spread over each, None for every tile)."""
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
        check_small(driver, smp, dev, tag, make_scene, make_li, res, spp, make_cam)

    def hold_frame(tag, scene, cam, cfg, li, want, first, limit=None):
        hold_wavefronts(kern, clmod, driver, tile, tag, scene, cam, cfg, li, want, first, limit)

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


def appearance_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line):
    """Phases 24–26: the appearance slice. Path at depth 5, compact_from=1,
    zerotwo on the bench scene with a metal blob and with a subsurface blob
    (512×512, 1 spp) and on the appearance box (256×256, 16 spp in one
    wavefront of 1,048,576 lanes): every wavefront one frame sends (the
    subsurface probes' windowed closest-hit launches and the exit points'
    any-hit launches among them) held to the plain versions on PLAIN_TILES
    tiles spread over it, bit for bit with equal test counts; one warm-up
    and two timed frames with the launches a frame, one profiled frame's GPU
    launches, 0 NaN, peak memory. Then at 16×16 on the card against the
    plain versions on the CPU (the pixel check): path on the box and on the
    subsurface bench, direct, volpath, BDPT (1 spp, depth 3) and SPPM on
    the box. Returns
    ({path: kernel launches}, {path: frames})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.integrate import bdpt, direct, path, sppm, volpath
    by_path, frames_by = {}, {}
    depth, frames = 5, 2
    # a frame's launches: the primary, then each bounce's fused extension,
    # and with a subsurface row two probe launches and the exit's shadow query
    plain = {"coverage": depth + 1, "closest": depth + 1, "occluded": 0}
    sss = {"coverage": 1 + 4 * depth, "closest": 1 + 3 * depth, "occluded": depth}

    def phase(tag, scene, render, want, lanes):
        t0 = time.perf_counter()
        sent = sent_wavefronts(clmod, render)
        # the unfused closest-hit launches after the primary are the probes;
        # `windowed`: those with a live lane in a finite window
        probes = [w for k, w in sent[1:] if k == "closest" and w[4] is None]
        windowed = sum(1 for w in probes if bool(((w[3] > 0) & torch.isfinite(w[3])).any()))
        held = check_sent(kern, clmod, scene.clusters, sent, tile, tag, PLAIN_TILES)
        kinds = {k: sum(1 for h in held if h[0] == k) for k in ("closest", "occluded")}
        n_probes = len(probes)
        del sent, probes
        log(f"{tag}_wavefronts", held=held, probe_launches=n_probes,
            probe_launches_windowed=windowed,
            compared_tiles_each=PLAIN_TILES, all_compared_equal=True,
            seconds=f"{time.perf_counter() - t0:.2f}")
        if kinds != {"closest": want["closest"], "occluded": want["occluded"]}:
            fail(f"{tag}: traced {kinds} wavefronts, expected {want}")
        if n_probes != (2 * depth if want["occluded"] else 0) or (n_probes and not windowed):
            fail(f"{tag}: {n_probes} probe launches ({windowed} with a live window)")
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        (img, stats), ms, launches = timed_frames(render, kernels, frames)
        per_frame = {k: v // frames for k, v in launches.items()}
        rays = float(stats["rays_traced"])
        n_nan = int(torch.isnan(img).sum())
        by_path[tag], frames_by[tag] = launches, frames
        log(tag, lanes=lanes, frame_ms=[round(t, 3) for t in ms], rays_per_frame=rays,
            mrays_per_s=f"{rays * frames / sum(ms) / 1e3:.3f}",
            gpu_launches_per_frame=gpu_launches(render), launches_per_frame=per_frame,
            peak_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.3f}",
            image_mean=f"{float(img.mean()):.6f}", nan=n_nan, card=f"'{smi_line}'",
            seconds=f"{time.perf_counter() - t0:.2f}")
        if n_nan or not bool(torch.isfinite(img).all()):
            fail(f"{tag}: image is not finite")
        if per_frame != want or any(v % frames for v in launches.values()):
            fail(f"{tag}: launches over {frames} frames {launches}, expected {want} a frame")

    # 24. the bench path frame with a metal and with a subsurface blob
    res = 512
    cam = scenes_mod.bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=depth,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = driver.lane_ids(cfg, 0, 1, dev)
    li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)
    for tag, blob, want in (("bench_metal", "metal", plain),
                            ("bench_subsurface", "subsurface", sss)):
        scene = scenes_mod.bench_scene(6, dev, blob=blob)

        def frame(s=scene):
            img, stats = driver.render_lanes(s, cam, cfg, li, pid, sid)[0]
            return img.reshape(res, res, 3), stats

        phase(tag, scene, frame, want, res * res)
        del scene, frame

    # 25. the appearance box, 256×256 at 16 spp in one wavefront
    ares, aspp = 256, 16
    box = scenes_mod.appearance_box(dev)
    acam = scenes_mod.cornell_camera((ares, ares), dev)
    acfg = driver.RenderConfig(width=ares, height=ares, spp=aspp, max_depth=depth,
                               sampler=smp.SamplerConfig(kind="zerotwo", spp=aspp))
    ali = path.make_li(acfg, camera=acam, compact_from=1, return_stats=True)
    phase("appearance_box", box, lambda: driver.render(box, acam, acfg, ali), sss,
          ares * ares * aspp)
    log("appearance_box_kinds", materials=list(box.materials.kinds_present),
        textures=list(box.textures.kinds_present),
        channels=list(box.materials.tex_channels), bump=box.materials.has_bump)
    del box

    # 26. 16×16: the card against the plain versions on the CPU
    def parity(tag, make_scene, make_cam, render):
        t0 = time.perf_counter()
        imgs = [render(make_scene(d), make_cam((16, 16), d)).cpu().numpy()
                for d in (dev, "cpu")]
        frac, mdiff, ok = pixel_check(*imgs)
        log(tag, pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
            max_rel_diff=f"{np.max(np.abs(imgs[0] - imgs[1]) / np.maximum(np.abs(imgs[1]), 1e-2)):.3e}",
            mean=f"{imgs[0].mean():.6f}", seconds=f"{time.perf_counter() - t0:.2f}",
            passed=ok)
        if not ok or not np.isfinite(imgs[0]).all() or imgs[0].mean() <= 0:
            fail(f"{tag}: the render through the kernels disagrees with the plain versions")

    c16 = driver.RenderConfig(width=16, height=16, spp=4, max_depth=depth,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=4))
    box16 = scenes_mod.appearance_box
    for tag, make_scene, make_cam, li16 in (
            ("appearance_path_16x16", box16, scenes_mod.cornell_camera, path.make_li(c16)),
            ("bench_subsurface_path_16x16",
             lambda d: scenes_mod.bench_scene(6, d, blob="subsurface"),
             scenes_mod.bench_camera, path.make_li(c16)),
            ("appearance_direct_16x16", box16, scenes_mod.cornell_camera, direct.make_li(c16)),
            ("appearance_volpath_16x16", box16, scenes_mod.cornell_camera,
             volpath.make_li(c16))):
        parity(tag, make_scene, make_cam, lambda s, c, li=li16: driver.render(s, c, c16, li))
    # BDPT at 1 spp, depth 3: its connections evaluate every kind's BSDF and
    # every texture at each vertex pair, some 170 s of the CPU's at depth 5
    b16 = bdpt.BDPTConfig(width=16, height=16, spp=1, max_depth=3,
                          sampler=smp.SamplerConfig(kind="random", spp=1))
    parity("appearance_bdpt_16x16", box16, scenes_mod.cornell_camera,
           lambda s, c: bdpt.render(s, c, b16))
    s16 = sppm.SPPMConfig(width=16, height=16, n_iterations=2, photons_per_iter=4096,
                          max_depth=depth, gather="grid")
    parity("appearance_sppm_16x16", box16, scenes_mod.cornell_camera,
           lambda s, c: sppm.render(s, c, s16))
    return by_path, frames_by


# The bench scene (scenes.bench_scene) as a scene file: the blob from
# blob.ply, the room, its light and the bench camera. The loader has no
# Texture directive, so the floor is the walls' matte
BENCH_PBRT = """LookAt 0.5 0.5 1.35  0.5 0.35 -0.5  0 1 0
Camera "perspective" "float fov" [42]
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
Sampler "lowdiscrepancy" "integer pixelsamples" [1]
Integrator "path" "integer maxdepth" [5]
WorldBegin
  AttributeBegin
    Material "plastic" "rgb Kd" [0.4 0.25 0.12] "rgb Ks" [0.3 0.3 0.3] "float roughness" [0.08]
    Shape "plymesh" "string filename" "blob.ply"
  AttributeEnd
  Material "matte" "rgb Kd" [0.73 0.73 0.73]
  Shape "trianglemesh" "point P" [0 0 0  1 0 0  1 0 -1  0 0 -1] "integer indices" [0 1 2 0 2 3]
  Shape "trianglemesh" "point P" [0 1 0  0 1 -1  1 1 -1  1 1 0] "integer indices" [0 1 2 0 2 3]
  Shape "trianglemesh" "point P" [0 0 -1  1 0 -1  1 1 -1  0 1 -1] "integer indices" [0 1 2 0 2 3]
  AttributeBegin
    Material "matte" "rgb Kd" [0 0 0]
    AreaLightSource "diffuse" "rgb L" [14 14 14]
    Shape "trianglemesh"
          "point P" [0.25 0.999 -0.25  0.25 0.999 -0.75  0.75 0.999 -0.75  0.75 0.999 -0.25]
          "integer indices" [0 1 2 0 2 3]
  AttributeEnd
WorldEnd
"""


def frontend_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line, res=512):
    """Phases 27–29: the front end and the sensor. 27: the bench blob
    written as a binary PLY beside a .pbrt file of the bench room, light
    and camera; load_pbrt on the card (its triangles bit for bit the
    blob's), one path frame (512×512, depth 5, the file's zerotwo at 1 spp,
    compact_from=1) with its primary and first fused wavefronts held to the
    plain versions on PLAIN_TILES tiles, the image through write_exr,
    write_pfm, write_npy and write_png and back (the first three bit for
    bit). 28: the loaded scene through each other camera and filter, one
    frame each at 512×512, its primary wavefront held: thin lens + mitchell,
    orthographic + gaussian, environment + triangle, realistic (DEMO_LENS) +
    lanczos (path), thin lens + mitchell (direct). 29: the thin-lens
    mitchell path render at 16×16 on the card against the CPU. Each frame:
    ms, GPU launches, launches, 0 NaN. Returns ({path: kernel launches},
    {path: frames})."""
    import os
    import tempfile
    import numpy as np
    import torch
    from pbrt_tpu_torch.cameras import cameras as cammod, realistic
    from pbrt_tpu_torch.core import transform as tf
    from pbrt_tpu_torch.film import filters, io as imageio
    from pbrt_tpu_torch.geom import meshio
    from pbrt_tpu_torch.integrate import direct, path
    from pbrt_tpu_torch.pbrt_loader import load_pbrt
    by_path, frames_by = {}, {}
    six = {"coverage": 6, "closest": 6, "occluded": 0}
    three = {"coverage": 3, "closest": 2, "occluded": 1}

    def frame_phase(tag, scene, cam, cfg, li, want, first, extra=None):
        n = cfg.width * cfg.height * cfg.spp
        if want == six:       # the primary, then five fused launches of m + m lanes
            widths = [n] + [path._compact_width(n, b, 1) for b in range(1, cfg.max_depth)]
            shapes = [("closest", n, None)] + [("closest", 2 * m, m) for m in widths]
        else:                 # the primary, the shadow query, the BSDF-sampled ray
            shapes = [("closest", n, None), ("occluded", n, None), ("closest", n, None)]
        hold_wavefronts(kern, clmod, driver, tile, tag, scene, cam, cfg, li, shapes, first,
                        PLAIN_TILES)
        t0 = time.perf_counter()

        def render():
            return driver.render(scene, cam, cfg, li)

        (img, stats), ms, launches = timed_frames(render, kernels, 1)
        by_path[tag], frames_by[tag] = launches, 1
        n_nan = int(torch.isnan(img).sum())
        log(tag, resolution=f"{cfg.width}x{cfg.height}", spp=cfg.spp, depth=cfg.max_depth,
            camera=type(cam).__name__, filter=cfg.filter.kind, frame_ms=ms,
            rays_per_frame=float(stats["rays_traced"]),
            gpu_launches_per_frame=gpu_launches(render), launches_per_frame=launches,
            image_mean=f"{float(img[torch.isfinite(img)].mean()):.6f}", nan=n_nan,
            **(extra or {}), card=f"'{smi_line}'", seconds=f"{time.perf_counter() - t0:.2f}")
        if n_nan or not bool(torch.isfinite(img).all()) \
                or tuple(img.shape) != (cfg.height, cfg.width, 3):
            fail(f"{tag}: image is not finite")
        if launches != want:
            fail(f"{tag}: launches {launches}, expected {want} a frame")
        return img

    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # 27. the scene file, loaded on the card
        t0 = time.perf_counter()
        v, f, vn = meshio.bench_blob(6)
        v = v + np.array([0.5, 0.35, -0.5], np.float32)
        meshio.write_ply(os.path.join(tmp, "blob.ply"), v, f, normals=vn)
        pbrt_file = os.path.join(tmp, "bench.pbrt")
        with open(pbrt_file, "w") as fh:
            fh.write(BENCH_PBRT.format(res=res))
        scene, cam, opts = load_pbrt(pbrt_file, device=dev)
        bits = lambda a: np.ascontiguousarray(a).view(np.int32)  # noqa: E731
        same = bool(np.array_equal(bits(scene.tri.positions[:len(v)].cpu().numpy()), bits(v))
                    and np.array_equal(scene.tri.indices[:len(f)].cpu().numpy(), f)
                    and np.array_equal(bits(scene.tri.normals[:len(v)].cpu().numpy()),
                                       bits(vn)))
        want_opts = {"integrator": "path", "max_depth": 5, "sampler": "zerotwo", "spp": 1}
        log("frontend_load", triangles=scene.tri.count, blob_triangles=len(f),
            clusters=None if scene.clusters is None else scene.clusters.n_clusters,
            blob_bit_equal=same, options=opts, camera=type(cam).__name__,
            resolution=cam.resolution, seconds=f"{time.perf_counter() - t0:.2f}")
        if not same or opts != want_opts or cam.resolution != (res, res) \
                or scene.clusters is None or scene.tri.count != len(f) + 8:
            fail("frontend_load: the loaded scene is not the bench scene file's")
        cfg = driver.RenderConfig(width=res, height=res, spp=opts["spp"],
                                  max_depth=opts["max_depth"],
                                  sampler=smp.SamplerConfig(kind=opts["sampler"],
                                                            spp=opts["spp"]))
        li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)
        img = frame_phase("frontend_bench", scene, cam, cfg, li, six, 2)
        t0 = time.perf_counter()
        host = img.cpu().numpy()
        equal = {}
        for ext in ("exr", "pfm", "npy", "png"):
            name = os.path.join(tmp, f"frontend.{ext}")
            imageio.write_image(name, img)
            back = imageio.read_image(name)
            equal[ext] = (bool(np.array_equal(bits(back), bits(host))) if ext != "png"
                          else back.shape == host.shape and bool(np.isfinite(back).all()))
        log("frontend_images", bit_equal=equal, bytes={e: os.path.getsize(
            os.path.join(tmp, f"frontend.{e}")) for e in equal},
            seconds=f"{time.perf_counter() - t0:.2f}")
        if not all(equal.values()):
            fail(f"frontend_images: an image did not read back as written: {equal}")

        # 28. the other cameras and filters on the loaded scene
        c2w = tf.look_at_np([0.5, 0.5, 1.35], [0.5, 0.35, -0.5], [0.0, 1.0, 0.0])
        ortho = c2w.copy()
        ortho[:3, :3] *= 0.6                   # the room fills the screen window
        lens = dict(lens_radius=0.025, focal_distance=1.8)

        def thin(size, d):
            return cammod.make_perspective(c2w, 42.0, size, d, **lens)

        cams = {"thin": thin((res, res), dev),
                "ortho": cammod.make_orthographic(ortho, (res, res), dev),
                "env": cammod.make_environment(tf.look_at_np(
                    [0.5, 0.5, -0.2], [0.5, 0.5, -1.0], [0.0, 1.0, 0.0]), (res, res), dev),
                "real": realistic.make_realistic(c2w, realistic.DEMO_LENS, (res, res), dev,
                                                 focus_distance=1.8)}
        mitchell = filters.Filter("mitchell", radius=2.0)
        for tag, key, filt, integ in (
                ("cameras_thin_lens_mitchell", "thin", mitchell, "path"),
                ("cameras_orthographic_gaussian", "ortho", filters.Filter("gaussian", radius=1.5),
                 "path"),
                ("cameras_environment_triangle", "env", filters.Filter("triangle", radius=2.0),
                 "path"),
                ("cameras_realistic_lanczos", "real", filters.Filter("lanczos", radius=4.0),
                 "path"),
                ("cameras_thin_lens_mitchell_direct", "thin", mitchell, "direct")):
            c = cfg._replace(filter=filt)
            cam_k = cams[key]
            extra = None
            if key == "real":
                pid, sid = driver.lane_ids(c, 0, 1, dev)
                cw = driver.camera_rays(cam_k, c, pid, sid)[2]
                extra = {"vignetted_share": f"{1.0 - float(cw.mean()):.4f}"}
            if integ == "path":
                frame_phase(tag, scene, cam_k, c, path.make_li(c, camera=cam_k, compact_from=1,
                                                               return_stats=True), six, 1, extra)
            else:
                frame_phase(tag, scene, cam_k, c, direct.make_li(c, "one", return_stats=True),
                            three, 1, extra)
        del scene, cams

        # 29. 16×16, the thin lens and mitchell, the card against the CPU
        check_small(driver, smp, dev, "cameras_thin_lens_mitchell_16x16",
                    lambda d: load_pbrt(pbrt_file, device=d)[0], lambda c: path.make_li(c),
                    16, 4, thin, filt=mitchell)
    log("frontend_phases", seconds=f"{time.perf_counter() - t_all:.2f}")
    return by_path, frames_by


def last_slice_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line, bench,
                      res=512):
    """Phases 30–32: instances, the other accelerators and the CPU oracle.
    30: the instance field (scenes.instance_field: 64 instances of a
    1,280-triangle prototype, 16 moving over the shutter, and an emissive
    instance) at 512×512, path at depth 5, 1 spp, zerotwo, compact_from=1:
    every wavefront of the primary and the first fused trace — the scene
    pool's and each prototype's object-space pair wavefront — held to the
    plain versions on PLAIN_TILES tiles spread over it, bit for bit with
    equal test counts; both prototypes carry cluster sets, each set whose
    pre-cull finds pairs in a trace launches once in it, and the tracer
    launches are FIELD_PER_SET and FIELD_LAUNCHES; one warm-up, two timed
    frames, one profiled frame's GPU launches, peak memory, 0 NaN; then the field at 16×16 (n_side 3, 4
    spp) on the card against the plain versions on the CPU. 31: the bench
    scene through geom/bvh.py in place of its clusters (the primary and one
    fused bounce wavefront at 512×512, their hits against the cluster
    kernels' within tests/test_torch_cluster.py's tolerances, the steps and
    ms), and the kd-tree of bench_blob(4) (its build seconds, its primary
    hits against the brute-force tracer on the card). 32: config 1's 64×64
    direct render (point and area light, random sampler, 4 spp) on the card
    against the port's oracle.render_direct: the pixel check. Returns
    ({path: kernel launches}, {path: frames})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch.geom import bvh as bvhmod, instances as instmod, kdtree as kdmod
    from pbrt_tpu_torch.geom import meshio
    from pbrt_tpu_torch.geom import scene as scenemod, triangle as trimod
    from pbrt_tpu_torch.geom.types import triangles_from_numpy
    from pbrt_tpu_torch.integrate import direct, path
    from pbrt_tpu_torch.oracle import cpu_reference as oracle
    by_path, frames_by = {}, {}
    t_all = time.perf_counter()

    # 30. the instance field
    t0 = time.perf_counter()
    frames = 2
    field = scenes_mod.instance_field(device=dev, tile=tile)
    cam = scenes_mod.bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)

    def render():
        return driver.render(field, cam, cfg, li)

    log("instance_field_scene", triangles=field.tri.count,
        instances=[s.count for s in field.instances],
        prototype_triangles=[s.proto.count for s in field.instances],
        prototype_clusters=[s.clusters.n_clusters for s in field.instances],
        animated=[s.animated for s in field.instances],
        stored_triangles=field.tri.count + sum(s.proto.count for s in field.instances),
        instanced_triangles=sum(s.count * s.proto.count for s in field.instances),
        seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    if any(s.clusters is None for s in field.instances):
        fail("instance_field: a prototype has no cluster set, so its pairs would miss the "
             "kernels")
    sent = sent_with_sets(clmod, render, instmod)
    # a trace is the scene pool's launch, then each set's pre-cull and, where
    # it found pairs, one launch through the set's prototype
    traces = []
    for kind, cs, w in sent:
        if kind != "pairs" and cs is field.clusters:
            traces.append([])
        traces[-1].append((kind, cs, w))
    launched = [(k, cs, w) for k, cs, w in sent if k != "pairs"]
    recorded = {"coverage": len(launched),
                "closest": sum(k == "closest" for k, _, _ in launched),
                "occluded": sum(k == "occluded" for k, _, _ in launched)}
    per_set = {i: sum(cs is s.clusters for _, cs, _ in launched)
               for i, s in enumerate(field.instances)}
    found = [[next((w for k, c, w in t if k == "pairs" and c is s), None)
              for s in field.instances] for t in traces]
    missed = [(ti, i) for ti, t in enumerate(traces) for i, s in enumerate(field.instances)
              if found[ti][i] is None or sum(k != "pairs" and c is s.clusters
                                             for k, c, _ in t) != (found[ti][i] > 0)]
    if len(traces) != 6 or any(t[0][0] != "closest" for t in traces) or missed \
            or per_set != FIELD_PER_SET or recorded != FIELD_LAUNCHES:
        fail(f"instance_field: traces {[[k for k, _, _ in t] for t in traces]}, pairs "
             f"{found}, prototype launches {per_set}, launches {recorded}; expected 6 "
             f"traces, one launch a set with pairs in each (missed: {missed}), "
             f"{FIELD_PER_SET} and {FIELD_LAUNCHES}")
    held = []
    for ti, trace_ in enumerate(traces[:2]):
        for wi, (kind, cs, w) in enumerate(trace_):
            if kind == "pairs":
                continue
            who = "scene" if cs is field.clusters else "proto" + str(next(
                i for i, s in enumerate(field.instances) if s.clusters is cs))
            held += check_sent(kern, clmod, cs, [(kind, w)], tile,
                               f"instance_field_t{ti}_{who}", PLAIN_TILES)
    pairs = [(k, int(w[0].shape[0])) for t in traces for k, cs, w in t
             if k != "pairs" and cs is not field.clusters]
    del sent, traces, launched
    log("instance_field_wavefronts", held=held, prototype_wavefronts=pairs,
        pairs_by_trace=found,
        launches_by_prototype=per_set, compared_tiles_each=PLAIN_TILES,
        all_compared_equal=True, seconds=f"{time.perf_counter() - t0:.2f}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (img, stats), ms, launches = timed_frames(render, kernels, frames)
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_frame = {k: v // frames for k, v in launches.items()}
    rays = float(stats["rays_traced"])
    n_nan = int(torch.isnan(img).sum())
    by_path["instance_field"], frames_by["instance_field"] = launches, frames
    log("instance_field", resolution=f"{res}x{res}", spp=1, depth=5,
        frame_ms=[round(t, 3) for t in ms], rays_per_frame=rays,
        mrays_per_s=f"{rays * frames / sum(ms) / 1e3:.3f}",
        gpu_launches_per_frame=gpu_launches(render), launches_per_frame=per_frame,
        peak_memory_gib=f"{peak:.3f}", image_mean=f"{float(img.mean()):.6f}", nan=n_nan,
        card=f"'{smi_line}'", seconds=f"{time.perf_counter() - t0:.2f}")
    if n_nan or not bool(torch.isfinite(img).all()) or tuple(img.shape) != (res, res, 3):
        fail("instance_field: image is not finite")
    if per_frame != FIELD_LAUNCHES or any(v % frames for v in launches.values()):
        fail(f"instance_field: launches over {frames} frames {launches}, expected "
             f"{FIELD_LAUNCHES} a frame")
    del field, img
    check_small(driver, smp, dev, "instance_field_16x16",
                lambda d: scenes_mod.instance_field(n_side=3, device=d, tile=tile),
                lambda c: path.make_li(c), 16, 4, scenes_mod.bench_camera)

    # 31. the BVH on the bench scene; the kd-tree on bench_blob(4)
    t0 = time.perf_counter()
    pos, idx = bench.tri.positions.cpu().numpy(), bench.tri.indices.cpu().numpy()
    bvh = bvhmod.build_bvh(pos, idx, device=dev)
    build_s = time.perf_counter() - t0
    pid, sid = driver.lane_ids(cfg, 0, 1, dev)
    o, d, _, _ = driver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    n = o.shape[0]
    t_min = torch.full((n,), 1e-4, device=dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    ob, db, tminb, tmaxb, _ = bounce_wavefront(bench, o, d, scenemod.intersect(bench, o, d))

    def agree(tag, bvh_res, ref, steps, ms, extra):
        h, t, i = (a for a in bvh_res[:3])
        rh, rt, ri = ref[:3]
        both = h & rh
        hit_agree = float((h == rh).float().mean())
        tri_agree = float((i[both] == ri[both]).float().mean())
        t_ok = bool(torch.allclose(t[both], rt[both], rtol=1e-3))
        log(tag, lanes=int(h.shape[0]), steps=steps, ms=f"{ms:.3f}",
            hit_agreement=f"{hit_agree:.6f}", triangle_agreement=f"{tri_agree:.6f}",
            t_within_rtol=t_ok, hit_share=f"{float(h.float().mean()):.4f}", **extra)
        if hit_agree <= 0.995 or tri_agree <= 0.99 or not t_ok:
            fail(f"{tag}: the BVH's hits disagree with the cluster kernels'")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    (res_p, steps), ms_p = timed(lambda: bvhmod.traverse(bvh, bench.tri, o, d, t_min, t_max,
                                                         False, True))
    agree("bvh_primary", res_p, clmod.intersect(bench.clusters, o, d, t_min, t_max, tile),
          steps, ms_p, dict(nodes=bvh.n_nodes, build_seconds=f"{build_s:.3f}"))
    ext = (ob[:n], db[:n], tminb[:n], tmaxb[:n])
    sh = (ob[n:], db[n:], tminb[n:], tmaxb[n:])
    (res_b, steps_b), ms_b = timed(lambda: bvhmod.traverse(bvh, bench.tri, *ext, False, True))
    (occ, steps_a), ms_a = timed(lambda: bvhmod.traverse(bvh, bench.tri, *sh, True, True))
    ref_b, ref_occ = clmod.intersect_occluded(bench.clusters, *ext, *sh, tile)
    occ_agree = float((occ[0] == ref_occ).float().mean())
    agree("bvh_bounce", res_b, ref_b, steps_b, ms_b,
          dict(any_hit_steps=steps_a, any_hit_ms=f"{ms_a:.3f}",
               occluded_agreement=f"{occ_agree:.6f}"))
    if occ_agree <= 0.995:
        fail("bvh_bounce: the BVH's any hits disagree with the cluster kernels'")
    del bvh, res_p, res_b, occ
    t0 = time.perf_counter()
    v, f, vn = meshio.bench_blob(4)
    v = v + np.array([0.5, 0.35, -0.5], np.float32)
    kd = kdmod.build_kdtree(v, f, device=dev)
    kd_build = time.perf_counter() - t0
    tri = triangles_from_numpy(v, f, vn, np.zeros((len(v), 2), np.float32),
                               np.ones(len(f), bool), np.zeros(len(f)), np.full(len(f), -1), dev)
    (kres, ksteps), kms = timed(lambda: kdmod.traverse_closest(kd, tri, o, d, t_min, t_max,
                                                               True))
    bres, bms = timed(lambda: trimod.intersect_brute(tri, o, d, t_min, t_max))
    kh, kt, ki = kres[:3]
    bh, bt, bi = bres[:3]
    both = kh & bh
    mism = dict(hit_mismatches=int((kh != bh).sum()),
                triangle_mismatches=int((ki[both] != bi[both]).sum()),
                t_mismatches=int((kt[both] != bt[both]).sum()))
    log("kdtree_blob4", triangles=len(f), nodes=int(kd.axis.shape[0]),
        build_seconds=f"{kd_build:.3f}", lanes=n, steps=ksteps, ms=f"{kms:.3f}",
        brute_ms=f"{bms:.3f}", hit_share=f"{float(kh.float().mean()):.4f}", **mism)
    if (kh != bh).float().mean() >= 0.005 or (ki[both] != bi[both]).float().mean() >= 0.01:
        fail("kdtree_blob4: the kd-tree's hits disagree with the brute-force tracer's")
    del kd, tri

    # 32. config 1's direct render against the port's CPU oracle
    res1, spp1 = 64, 4
    c1 = driver.RenderConfig(width=res1, height=res1, spp=spp1,
                             sampler=smp.SamplerConfig(kind="random", spp=spp1, seed=0))
    for light in ("point", "area"):
        t0 = time.perf_counter()
        box = scenes_mod.cornell_spheres(light=light, device=dev, tile=tile)
        bcam = scenes_mod.cornell_camera((res1, res1), dev)
        img = driver.render(box, bcam, c1, direct.make_li(c1)).cpu().numpy()
        with np.errstate(invalid="ignore"):     # the oracle's 0 · inf on rays that miss
            ref = oracle.render_direct(box, bcam, res1, res1, spp1, seed=0)
        frac, mdiff, ok = pixel_check(img, ref)
        log(f"oracle_cornell_{light}", resolution=f"{res1}x{res1}", spp=spp1,
            pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
            mean=f"{img.mean():.6f}", seconds=f"{time.perf_counter() - t0:.2f}", passed=ok)
        if not ok or not np.isfinite(img).all():
            fail(f"oracle_cornell_{light}: the render on the card disagrees with the oracle")
    log("last_slice_phases", seconds=f"{time.perf_counter() - t_all:.2f}")
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


def grad_phases(kern, clmod, driver, smp, dev, tile, kernels, row_grads):
    """Phases 15–18, baseline config 5 (inverse rendering): gradients by
    path replay on torch.autograd, the tracers on detached rays, a
    one-rank NCCL group for the sharded steps; each step's backward
    launches row_grad_kernel once a gather of kd or emit rows (diff/rows.py),
    counted a phase into row_grads["launches"] ({path tag: (launches,
    steps)}), and phase 17's first step's launches are held to the plain
    version (check_row_grad, into row_grads["held"]). Returns ({path tag:
    kernel launches}, {path tag: steps})."""
    import numpy as np
    import torch
    from pbrt_tpu_torch import scenes as scenes_mod
    from pbrt_tpu_torch import trace
    from pbrt_tpu_torch.diff import demo
    from pbrt_tpu_torch.diff import rows as rowmod
    from pbrt_tpu_torch.dist import multihost, sharding
    from pbrt_tpu_torch.integrate import direct, path
    by_path, steps_by = {}, {}
    row_by = row_grads["launches"] = {}

    def rows_held(tag, gathers, steps, per_step):
        """The phase's row_grad launches: one a gather that took the kernel
        (the `diff.row_grads` count, where the phase recorded it), and
        per_step a step."""
        got = rowmod.row_grad.launches
        row_by[tag] = (got, steps)
        if got != per_step * steps or gathers not in (None, got):
            fail(f"{tag}: {got} row_grad_kernel launches over {steps} steps and {gathers} "
                 f"gathers through the kernel, expected {per_step} a step")

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
        rowmod.row_grad.launches = 0
        with trace.recording() as rec:
            sent = sent_wavefronts(clmod, lambda: step(bad, cam, target, 4.0))
        tag = f"grad_wavefronts_{integrator}"
        by_path[tag], steps_by[tag] = counts(), 1
        rows_held(tag, rec.counters().get("diff.row_grads"), 1, ROW_GRADS_A_STEP[integrator])
        held = check_sent(kern, clmod, bad.clusters, sent, tile, tag)
        kinds = {k: sum(1 for h in held if h[0] == k) for k in ("closest", "occluded")}
        log(tag, held=held, launches_per_step=by_path[tag],
            row_grad_launches_per_step=row_by[tag][0],
            seconds=f"{time.perf_counter() - t0:.2f}", all_tiles_equal=True)
        if kinds != want or by_path[tag] != per_step:
            fail(f"{tag}: a training step traced {kinds} wavefronts, expected {want}; "
                 f"launches {by_path[tag]}, expected {per_step}")

    # 16. the same step's gradients on the card and on the CPU, 16×16
    t0 = time.perf_counter()
    got = {}
    for d in (dev, "cpu"):
        step, bad, cam, target = cornell_step(d, 16, 2, "path")
        rowmod.row_grad.launches = 0
        with trace.recording() as rec:
            loss, params, _ = step.forward(bad, cam, target)
        grads = step.backward(loss, params)
        if d == dev:
            rows_held("grad_cpu_parity", rec.counters().get("diff.row_grads"), 1,
                      ROW_GRADS_A_STEP["path"])
        elif rowmod.row_grad.launches or "diff.row_grads" in rec.counters():
            fail("grad_cpu_parity: the CPU's backward took the row gradient kernel")
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
        # the first step's row gathers' (ids, incoming gradient, rows), from
        # a stand-in under row_grad's name: the launches the real one counts
        # by that name land on the stand-in, and are handed back after
        real_row_grad, sent_rows = rowmod.row_grad, []

        def row_grad(idx, g, n_rows):
            if len(sent_rows) < ROW_GRADS_A_STEP["path"]:
                sent_rows.append((idx.clone(), g.clone(), n_rows))
            return real_row_grad(idx, g, n_rows)

        row_grad.launches = 0
        rowmod.row_grad = row_grad
        try:
            with trace.recording() as rec:
                out = demo.run(size=256, depth=5, device=dev, mesh=mesh, log=None)
            torch.cuda.synchronize()
        finally:
            rowmod.row_grad = real_row_grad
            real_row_grad.launches = row_grad.launches
        renders = demo.STEPS + 1          # the target, then one forward a step
        by_path["inverse_cornell"], steps_by["inverse_cornell"] = counts(), renders
        rows_held("inverse_cornell", rec.counters().get("diff.row_grads"), demo.STEPS,
                  ROW_GRADS_A_STEP["path"])
        secs = time.perf_counter() - t0
        log("inverse_cornell", resolution="256x256", spp=demo.SPP, depth=5, steps=demo.STEPS,
            lr=demo.LR, ranks=mesh.size, backend=backend,
            albedo_err=f"{out['albedo_err0']:.4f}->{out['albedo_err1']:.4f}",
            emit_err=f"{out['emit_err0']:.4f}->{out['emit_err1']:.4f}",
            loss_first=f"{out['losses'][0]:.6f}", loss_last=f"{out['losses'][-1]:.6f}",
            launches=counts(), renders=renders, row_grad_launches=row_by["inverse_cornell"][0],
            seconds=f"{secs:.2f}",
            ms_per_step=f"{secs * 1e3 / renders:.1f}", converged=out["converged"])
        if not out["converged"]:
            fail("inverse_cornell: the demo did not recover albedo and emission")
        if counts() != {"coverage": 6 * renders, "closest": 6 * renders, "occluded": 0}:
            fail(f"inverse_cornell: launches {counts()}, expected 6/6/0 a render")
        row_grads["held"] = check_row_grad(rowmod, sent_rows)
        by_path["inverse_bench"], steps_by["inverse_bench"] = inverse_bench(
            driver, smp, dev, mesh, kernels, rowmod)
        rows_held("inverse_bench", None, steps_by["inverse_bench"], ROW_GRADS_A_STEP["path"])
    finally:
        multihost.shutdown()
    return by_path, steps_by


def check_row_grad(rowmod, sent):
    """Phase 17b: row_grad_kernel (diff/rows.py) on the ids and incoming
    gradients that phase 17's first step sent it (256×256, 4 spp: 262,144
    lanes a gather; kd 6×3, emit 1×3): bit for bit its plain version, and
    again on a second launch. At the first kd and emit gathers its device
    ms (torch.profiler) and a call's ms by CUDA events (the wrapper's host
    issue), beside the bytes bound, the plain version, PyTorch's
    index_put_(accumulate=True) (the backward it replaced: sort, fill and
    kernels) and a one-hot matrix product (cuBLAS) as the library's
    deterministic route. Then tables of more than one chunk of 48 entries,
    262,144 ids 80% on row 0 or uniform, held to the plain version and
    timed beside index_put_."""
    import torch
    import torch.nn.functional as F
    if len(sent) != ROW_GRADS_A_STEP["path"]:
        fail(f"row_grad: phase 17's first step sent {len(sent)} row gathers")
    for idx, g, r in sent:
        blocks = rowmod.launch_grid(g.device, r * g.shape[1])[0]
        a, b = rowmod.row_grad(idx, g, r), rowmod.row_grad(idx, g, r)
        if not (torch.equal(a, b) and torch.equal(a, rowmod.row_grad_plain(idx, g, r, blocks))):
            fail(f"row_grad: the kernel disagrees with its plain version, or with itself, "
                 f"on a train step's gather of {r} rows")

    def timed(idx, g, r):
        c = g.shape[1]
        blocks, chunks = rowmod.launch_grid(g.device, r * c)

        def gemm():
            return (F.one_hot(idx, r).float().T @ g).reshape(-1)

        out = rowmod.row_grad(idx, g, r)
        return dict(
            lanes=int(idx.numel()), rows=r, cols=c, blocks=blocks, chunks=chunks,
            on_row_0=float((idx == 0).float().mean()),
            ms=device_ms(lambda: rowmod.row_grad(idx, g, r), 100, "row_grad_kernel"),
            call_ms=cuda_ms(lambda: rowmod.row_grad(idx, g, r), 100),
            plain_ms=cuda_ms(lambda: rowmod.row_grad_plain(idx, g, r, blocks), 3),
            library_ms=device_ms(lambda: torch.zeros((r, c), device=g.device).index_put_(
                (idx,), g, accumulate=True), 10),
            gemm_ms=device_ms(gemm, 100),
            gemm_repeats=bool(torch.equal(gemm(), gemm())),
            gemm_rel_diff=float((gemm() - out).abs().max() / out.abs().max()),
            bytes=int(idx.numel()) * (8 * chunks + 4 * c))

    kd = timed(*next(x for x in sent if x[2] == 6))
    emit = timed(*next(x for x in sent if x[2] == 1))
    log("row_grad_held", gathers=len(sent), equal_plain=True, repeats=True, kd=kd, emit=emit)
    gen = torch.Generator(device="cuda").manual_seed(11)
    n, chunked = 512 * 512, []
    for r, c in ((16, 3), (17, 3), (100, 3), (1000, 3), (10000, 3)):
        for on_row_0 in (0.8, 0.0):
            idx = torch.randint(0, r, (n,), device="cuda", generator=gen)
            idx = torch.where(torch.rand(n, device="cuda", generator=gen) < on_row_0, 0, idx)
            g = torch.rand((n, c), device="cuda", generator=gen) * 2.0 - 1.0
            blocks, chunks = rowmod.launch_grid(g.device, r * c)
            if not torch.equal(rowmod.row_grad(idx, g, r),
                               rowmod.row_grad_plain(idx, g, r, blocks)):
                fail(f"row_grad: {r}×{c} table ({chunks} chunks) disagrees with its plain "
                     "version")
            one = dict(rows=r, cols=c, on_row_0=on_row_0, blocks=blocks, chunks=chunks,
                       ms=device_ms(lambda: rowmod.row_grad(idx, g, r), 20, "row_grad_kernel"),
                       library_ms=device_ms(lambda: torch.zeros((r, c), device="cuda")
                                            .index_put_((idx,), g, accumulate=True), 5),
                       bound_ms=bound(0, n * (8 * chunks + 4 * c))[0])
            log("row_grad_chunks", lanes=n, equal_plain=True, **one)
            chunked.append(one)
    return dict(max_abs_err=0.0, ms=kd["ms"], call_ms=kd["call_ms"], plain_ms=kd["plain_ms"],
                library_ms=kd["library_ms"], gemm_ms=kd["gemm_ms"], bytes=kd["bytes"],
                shape=f"kd {kd['rows']}x{kd['cols']}, {kd['lanes']} lanes, a train step's "
                      "gather; ms: device time (torch.profiler)",
                emit=emit, chunks=chunked)


def zero_launches(kernels):
    for k in kernels.values():
        k.launches = 0


def inverse_bench(driver, smp, dev, mesh, kernels, rowmod, steps=4):
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
    rowmod.row_grad.launches = 0
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
    log("inverse_bench_launches_per_step", **per_step,
        row_grad=rowmod.row_grad.launches / steps)
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
    frames, by_path, frames_by, row_grads = 2, {}, {}, {}
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
        log(tag, resolution=f"{res}x{res}", spp=1, frame_ms=ms,
            mrays_per_s=f"{rays * frames / sum(times) / 1e6:.3f}", rays_per_frame=rays,
            image_mean=f"{float(img.mean()):.6f}", nan=n_nan, launches=launches)
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
                 grad_phases(kern, clmod, driver, smp, dev, tile, kernels, row_grads),
                 integrator_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line),
                 appearance_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line),
                 frontend_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line),
                 last_slice_phases(kern, clmod, driver, smp, dev, tile, kernels, smi_line,
                                   scene)):
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
            "occluded_kernel", "row_grad_kernel"} <= set(usage):
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
    held = row_grads["held"]
    r_bound, r_by = bound(0, held["bytes"])
    rows.append(dict(name="row_grad", route="cuda",
                     source="pbrt_tpu_torch/kernels/csrc/cluster.cu",
                     replaces="none: XLA's scatter-add under jax.grad",
                     launches=sum(v for v, _ in row_grads["launches"].values()),
                     launches_by_path={k: v for k, (v, _) in row_grads["launches"].items()},
                     launches_per_step_by_path={k: v / n for k, (v, n)
                                                in row_grads["launches"].items()},
                     max_abs_err=held["max_abs_err"], ms=held["ms"], call_ms=held["call_ms"],
                     plain_ms=held["plain_ms"], bound_ms=r_bound, bound_by=r_by,
                     library_ms=held["library_ms"], gemm_ms=held["gemm_ms"],
                     shape=held["shape"], emit=held["emit"], chunks=held["chunks"],
                     **resources("row_grad_kernel")))
    print(json.dumps({"kernels": rows}), flush=True)
    log("done", total_seconds=f"{time.perf_counter() - T0:.1f}")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
