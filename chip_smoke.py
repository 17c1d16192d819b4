#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (pbrt_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line with its elapsed seconds:
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. the CUDA kernel build (kernels/csrc/cluster.cu, nvcc, ctypes);
  3. the bench scene (81,928 triangles at subdivisions=6);
  4. each kernel against its plain PyTorch version on the card, on the
     bench scene's primary rays and on one fused bounce wavefront (about
     20% dead lanes, half shadow lanes), the plain version on at most 32
     tiles; kernel times by CUDA events;
  5. a 64×64 depth-5 render through the kernels (card) and through the
     plain versions (CPU), held to the pixel check of tests/test_oracle.py;
  6. the bench render, 512×512, depth 5, 1 spp, zerotwo, compact_from=1:
     one warm-up and two timed frames with the launch counts.
Then one JSON line with each kernel's numbers, the nvidia-smi line, and
the last line {"ok": true, "device": {...}}. Any failed check exits
non-zero before that line.
"""
import json
import subprocess
import sys
import time

T0 = time.perf_counter()
H100_F32_FLOPS = 67e12        # non-tensor-core float32 peak, H100 SXM at 700 W
H100_HBM_BYTES = 3.35e12      # HBM3 bytes/s, H100 SXM
PLAIN_TILES = 32              # tiles the plain versions are run on


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


def pick_tiles(nt, n_live_tiles):
    """Up to PLAIN_TILES tile ids spread over the live tiles, plus the
    first dead tile (live tiles first, as the plain version expects)."""
    import numpy as np
    live = np.unique(np.linspace(0, max(n_live_tiles - 1, 0),
                                 min(PLAIN_TILES - 1, n_live_tiles)).astype(int))
    dead = [n_live_tiles] if n_live_tiles < nt else []
    return list(live) + dead, len(live)


def sub_rays(rays, sel, tile):
    import torch
    return rays.view(8, -1, tile)[:, torch.as_tensor(sel, device=rays.device)] \
        .reshape(8, -1).contiguous()


def check_coverage(kern, cs, rays, tile, tag):
    """Kernel vs plain coverage on a tile subset; returns numbers."""
    import torch
    nt = rays.shape[1] // tile
    n_live = int((rays[7] > rays[6]).sum())
    nlt = (n_live + tile - 1) // tile
    nlt_t = torch.tensor([nlt], dtype=torch.int32, device=rays.device)
    tnear, covbits = kern.coverage(rays, cs.bounds, nlt_t, cs.n_clusters, tile)
    sel, n_sel_live = pick_tiles(nt, nlt)
    rs = sub_rays(rays, sel, tile)
    nls = torch.tensor([n_sel_live], dtype=torch.int32, device=rays.device)
    tp, cp = kern.coverage_plain(rs, cs.bounds, nls, cs.n_clusters, tile)
    ti = torch.as_tensor(sel, device=rays.device)
    bit_mismatch = int(torch.bitwise_xor(covbits[ti], cp).ne(0).sum())
    tn_k, tn_p = tnear[ti], tp
    tn_mismatch = int((tn_k != tn_p).sum())
    fin = torch.isfinite(tn_p)
    err = float((tn_k[fin] - tn_p[fin]).abs().max()) if bool(fin.any()) else 0.0
    log(f"coverage[{tag}]", tiles=nt, live_tiles=nlt, compared_tiles=len(sel),
        covbit_word_mismatches=bit_mismatch, tnear_mismatches=tn_mismatch)
    if bit_mismatch or tn_mismatch:
        fail(f"coverage[{tag}]: kernel and plain version disagree")
    ms = cuda_ms(lambda: kern.coverage(rays, cs.bounds, nlt_t, cs.n_clusters, tile), 20)
    kms = cuda_ms(lambda: kern.coverage(rs, cs.bounds, nls, cs.n_clusters, tile), 20)
    pms = cuda_ms(lambda: kern.coverage_plain(rs, cs.bounds, nls, cs.n_clusters, tile), 3)
    cpad = cs.bounds.shape[1]
    ops = nlt * tile * cpad * 28          # 4 mul/add + 5 min/max per axis, compare
    nbytes = rays.numel() * 4 + cs.bounds.numel() * 4 + nt * cpad * 4 + covbits.numel() * 4
    return dict(ms=ms, subset_kernel_ms=kms, plain_ms=pms, plain_tiles=len(sel),
                ops=ops, bytes=nbytes, tiles=nt, live_tiles=nlt, max_abs_err=err)


def check_closest(kern, clmod, cs, rays, flag, tile, tag):
    """Kernel vs plain closest hit on a tile subset; returns numbers."""
    import torch
    nt = rays.shape[1] // tile
    corder, tnear, counts, covbits = clmod.tile_cluster_order(cs, rays, tile)
    tests = torch.zeros(1, dtype=torch.int64, device=rays.device)
    t, slot, bary = kern.closest(cs.packed, rays, flag, corder, tnear, counts, covbits,
                                 tile, slot_tests=tests)
    n_live = int((rays[7] > rays[6]).sum())
    sel, _ = pick_tiles(nt, (n_live + tile - 1) // tile)
    ti = torch.as_tensor(sel, device=rays.device)
    rs = sub_rays(rays, sel, tile)
    fs = None if flag is None else flag.view(-1, tile)[ti].reshape(-1).contiguous()
    args = (cs.packed, rs, fs, corder[ti].contiguous(), tnear[ti].contiguous(),
            counts[ti].contiguous(), covbits[ti].contiguous(), tile)
    ptests = torch.zeros(1, dtype=torch.int64, device=rays.device)
    tp, sp, bp = kern.closest_plain(*args, slot_tests=ptests)
    ktests = torch.zeros(1, dtype=torch.int64, device=rays.device)
    kern.closest(*args, slot_tests=ktests)
    sk, tk, bk = slot[ti], t[ti], bary[ti]
    same = sk == sp
    frac = float(same.float().mean())
    hit = same & (sk >= 0)
    t_bad = int((~torch.isclose(tk[hit], tp[hit], rtol=1e-6, atol=0)).sum())
    b_bad = int((~torch.isclose(bk.permute(0, 2, 1)[hit], bp.permute(0, 2, 1)[hit],
                                rtol=1e-6, atol=0)).sum())
    exact = bool(same.all() and torch.equal(tk[hit], tp[hit]))
    err = max(float((tk[hit] - tp[hit]).abs().max()) if bool(hit.any()) else 0.0,
              float((bk.permute(0, 2, 1)[hit] - bp.permute(0, 2, 1)[hit]).abs().max())
              if bool(hit.any()) else 0.0)
    log(f"closest[{tag}]", tiles=nt, compared_tiles=len(sel),
        slot_agreement=f"{frac:.6f}", slot_mismatches=int((~same).sum()),
        t_mismatches=t_bad, bary_mismatches=b_bad, bit_exact=exact, max_abs_err=err,
        slot_tests_subset_kernel=int(ktests), slot_tests_subset_plain=int(ptests))
    if frac < 0.9999 or t_bad or b_bad:
        fail(f"closest[{tag}]: kernel and plain version disagree")
    ms = cuda_ms(lambda: kern.closest(cs.packed, rays, flag, corder, tnear, counts,
                                      covbits, tile), 10)
    kms = cuda_ms(lambda: kern.closest(*args), 10)
    pms = cuda_ms(lambda: kern.closest_plain(*args), 1)
    n_tests = int(tests)
    ops = n_tests * 49        # 44 mul/add of the slot test, 3 sign products, 2 min
    nbytes = (cs.packed.numel() * 4 + rays.numel() * 4 + corder.numel() * 8
              + covbits.numel() * 4 + nt * tile * 16)
    return dict(ms=ms, subset_kernel_ms=kms, plain_ms=pms, plain_tiles=len(sel),
                ops=ops, bytes=nbytes, tiles=nt, slot_tests=n_tests,
                mean_count=float(counts.float().mean()), max_abs_err=err)


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
        from pbrt_tpu_torch.integrate import driver, path
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

    # 2. kernel build
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
    # the int64 uint32 emulation must give the same streams on the card
    same = all(torch.equal(fn(cfg.sampler, pid, sid + 977, dim).cpu(),
                           fn(cfg.sampler, pid.cpu(), sid.cpu() + 977, dim))
               for fn in (smp.sample_1d, smp.sample_2d) for dim in (0, 5, 9000))
    log("sampler", card_equals_cpu=same)
    if not same:
        fail("sampler streams differ between the card and the CPU")
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

    # 5. 64×64 render: kernels on the card vs plain versions on the CPU
    t0 = time.perf_counter()
    small = 64
    cfg_s = driver.RenderConfig(width=small, height=small, spp=1, max_depth=5,
                                sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    cam_g = bench_camera((small, small), dev)
    img_k = driver.render(scene, cam_g, cfg_s, path.make_li(cfg_s, camera=cam_g,
                                                            compact_from=1)).cpu().numpy()
    scene_c = bench_scene(6, "cpu")
    cam_c = bench_camera((small, small), "cpu")
    img_p = driver.render(scene_c, cam_c, cfg_s, path.make_li(cfg_s, camera=cam_c,
                                                              compact_from=1)).numpy()
    frac, mdiff, ok = pixel_check(img_k, img_p)
    log("render64", pixels_within_tol=f"{frac:.4f}", mean_diff=f"{mdiff:.3e}",
        mean=f"{img_k.mean():.6f}", identical=bool(np.array_equal(img_k, img_p)),
        seconds=f"{time.perf_counter() - t0:.2f}", passed=ok)
    if not ok or not np.isfinite(img_k).all():
        fail("64x64 render through the kernels disagrees with the plain versions")

    # 6. the bench render
    li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)

    def frame():
        (rad, stats), wt = driver.render_lanes(scene, cam, cfg, li, pid, sid)
        return rad, stats

    frame()
    torch.cuda.synchronize()
    kern.coverage.launches = 0
    kern.closest.launches = 0
    frames, times, rays, img = 2, [], 0.0, None
    for _ in range(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rad, stats = frame()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        rays += float(stats["rays_traced"])
        img = rad
    launches = {"coverage": kern.coverage.launches, "closest": kern.closest.launches}
    img = img.reshape(res, res, 3)
    n_nan = int(torch.isnan(img).sum())
    ms = [t * 1e3 for t in times]
    occ = [round(float(x), 4) for x in stats["occupancy"]]
    log("bench", resolution=f"{res}x{res}", depth=5, spp=1, frame_ms=ms,
        mrays_per_s=f"{rays / sum(times) / 1e6:.3f}", rays_per_frame=rays / frames,
        occupancy=occ, image_mean=f"{float(img.mean()):.6f}", nan=n_nan,
        launches=launches)
    if n_nan or not bool(torch.isfinite(img).all()) or tuple(img.shape) != (res, res, 3):
        fail("bench image is not finite")
    if launches["coverage"] != 6 * frames or launches["closest"] != 6 * frames:
        fail(f"expected 6 launches of each kernel per frame, got {launches}")

    def row(name, source, replaces, launch, c_primary, c_bounce, by):
        c = c_bounce
        bound_ms = max(c["ops"] / H100_F32_FLOPS, c["bytes"] / H100_HBM_BYTES) * 1e3
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launch, max_abs_err=max(c_primary["max_abs_err"],
                                                     c["max_abs_err"]),
                    ms=c["ms"], plain_ms=c["plain_ms"],
                    bound_ms=bound_ms, bound_by=by, library_ms=None,
                    shape="fused_bounce", primary_ms=c_primary["ms"],
                    subset_kernel_ms=c["subset_kernel_ms"], plain_tiles=c["plain_tiles"])

    rows = [row("coverage", "pbrt_tpu_torch/kernels/csrc/cluster.cu",
                "pbrt_tpu/kernels/cluster_pallas.py:303", launches["coverage"],
                cov_p, cov_b, "operations"),
            row("closest", "pbrt_tpu_torch/kernels/csrc/cluster.cu",
                "pbrt_tpu/kernels/cluster_pallas.py:876", launches["closest"],
                cl_p, cl_b, "operations")]
    rows[1]["slot_tests"] = cl_b["slot_tests"]
    rows[1]["slot_tests_primary"] = cl_p["slot_tests"]
    print(json.dumps({"kernels": rows}), flush=True)
    log("done", total_seconds=f"{time.perf_counter() - T0:.1f}")
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                              "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
