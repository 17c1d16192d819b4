#!/usr/bin/env python3
"""A/B timing of builds of the ray-tracing kernels on the GPU, in one process.

    python3 chip_kernel_ab.py LABEL=SOURCE ... [--reps N] [--res N] [--probes]

Each SOURCE is a cluster.cu (this repository's, or an unpacked earlier
tree's) built with the port's nvcc flags, all builds started together.
Every build's `pbrt_coverage`, `pbrt_closest` and `pbrt_occluded` (the
same C interface in each) then run on the bench wavefronts of
chip_smoke.py at RES×RES (512 by default): coverage on all four, closest
hit on the primary rays and the fused bounce, any hit on the
direct-lighting shadow and the first AO wavefront. For each build and
wavefront the script prints the tests run and needed (the kernels'
counters; coverage's where the build has `pbrt_coverage_counted`), what
differs from the first build's results (the tracers' lanes; coverage's
covbits words and tnear columns), the kernels' registers and spill bytes
(nvcc -Xptxas -v), and the ms per launch by CUDA events: REPS launches
after a warm-up, the builds timed in turns, forward then backward (A B C
C B A), so a drift of the card's clock spreads over all of them. The
last line is one JSON object with every number. Needs a GPU; prints the
card's name and power limit.

With --probes the builds' probe kernels run instead, at the probe's
shapes (kernels/probes.py): the overhead probe's stage and stage+compute
at 64 clusters a tile and n5 = 1, ms per launch by CUDA events in turns
as above, with the lanes that differ from the first build's (a build
whose C interface has `pbrt_launch_floor` takes packed (C, 16, n5, K)
and n5; an earlier one takes (C, 24, K) and CH, given the same 16
features in its first 16 rows, so the results are equal); and every
build's compaction probe at tile 1,024 by its device time
(torch.profiler, 100 launches) and by its time a launch in a CUDA graph
of 100, beside the empty kernel's of the first build that has one.
"""
import ctypes
import json
import os
import subprocess
import sys
import time


def build(label, src, out_dir, flags, nvcc):
    so = os.path.join(out_dir, f"lib_{label}.so")
    cmd = [nvcc, *flags, "-Xptxas", "-v", "-o", so, src]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def load(so):
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pbrt_closest.restype = i
    lib.pbrt_closest.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.pbrt_occluded.restype = i
    lib.pbrt_occluded.argtypes = [p] * 8 + [i] * 6 + [p]
    lib.pbrt_coverage.restype = i
    lib.pbrt_coverage.argtypes = [p] * 5 + [i] * 4 + [p]
    if hasattr(lib, "pbrt_coverage_counted"):
        lib.pbrt_coverage_counted.restype = i
        lib.pbrt_coverage_counted.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.pbrt_compact_probe.restype = i
    lib.pbrt_compact_probe.argtypes = [p] * 4 + [i, p]
    lib.pbrt_overhead_probe.restype = i
    lib.pbrt_overhead_probe.argtypes = [i] + [p] * 5 + [i] * 5 + [p]
    if hasattr(lib, "pbrt_launch_floor"):
        lib.pbrt_launch_floor.restype = i
        lib.pbrt_launch_floor.argtypes = [p]
    return lib


def timed_in_turns(labels, call, reps):
    """{label: [ms, ms]}: ms per call(label) by CUDA events, REPS calls
    after a warm-up, the labels in the order A B .. B A."""
    import torch
    ms = {label: [] for label in labels}
    for label in list(labels) + list(labels)[::-1]:
        call(label)
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            call(label)
        b.record()
        torch.cuda.synchronize()
        ms[label].append(a.elapsed_time(b) / reps)
    return ms


def probe_ab(libs, reps):
    """The probe kernels of every build (see --probes above)."""
    import torch
    import chip_smoke as cs_
    from pbrt_tpu_torch.kernels import probes
    P = lambda x: ctypes.c_void_p(x.data_ptr())   # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    nt, tile, cpad, k = probes.NT, probes.TILE, probes.CPAD, probes.K
    new_builds = [lb for lb, lib in libs.items() if hasattr(lib, "pbrt_launch_floor")]
    results = {}

    def overhead_call(label, kind, inputs, out):
        """A launch of `label`'s overhead probe, its arguments fixed now."""
        lib, (packed, planes, corder, counts) = libs[label], inputs
        hold = [packed, planes, corder, counts, out]    # alive while the call is
        if label in new_builds:
            args = (kind, P(packed), P(planes), P(corder), P(counts), P(out), nt, tile, cpad,
                    packed.shape[2], k, stream)
        else:
            p24 = torch.zeros((packed.shape[0], 24, k), device=packed.device)
            p24[:, :probes.NFEAT] = packed[:, :, 0]
            hold.append(p24)
            args = (kind, P(p24), P(planes), P(corder), P(counts), P(out), nt, tile, cpad, k,
                    probes.CH, stream)

        def call():
            if lib.pbrt_overhead_probe(*args):
                sys.exit(f"{label}: overhead probe launch failed")
        call.hold = hold
        return call

    inputs = probes.overhead_inputs(64, "cuda", n5=1)
    for kind in ("stage", "stage+compute"):
        ki = probes.KINDS.index(kind)
        outs = {lb: torch.empty((nt, tile), device="cuda") for lb in libs}
        calls = {lb: overhead_call(lb, ki, inputs, outs[lb]) for lb in libs}
        ref, row = None, {}
        for label in libs:
            calls[label]()
            torch.cuda.synchronize()
            ref = outs[label] if ref is None else ref
            row[label] = dict(lanes_differ=int((outs[label] != ref).sum()))
        for label, ms in timed_in_turns(libs, lambda lb: calls[lb](), reps).items():
            row[label]["ms"] = ms
        for label, r in row.items():
            print(f"overhead n5=1 {kind:14s} counts=64 {label:12s} "
                  + " ".join(f"{key}={v}" for key, v in r.items()), flush=True)
        results[f"overhead[{kind} n5=1 counts=64]"] = row
    mask, val = probes.compact_inputs(1024, "cuda")
    out = torch.empty_like(val)
    slot = torch.empty((1, 1024), dtype=torch.int32, device="cuda")

    def launched(err):
        if err:
            sys.exit(f"probe launch failed: cudaError {err}")

    def current():
        return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    row = {}
    for label, lib in libs.items():
        def compact(lib=lib):
            launched(lib.pbrt_compact_probe(P(mask), P(val), P(out), P(slot), 1024, current()))
        row[label] = dict(device_ms=cs_.device_ms(compact, 100, "compact_probe_kernel"),
                          graph_ms=cs_.graph_ms(compact))
    if new_builds:
        def floor(lib=libs[new_builds[0]]):
            launched(lib.pbrt_launch_floor(current()))
        row["launch_floor"] = dict(build=new_builds[0],
                                   device_ms=cs_.device_ms(floor, 100, "launch_floor_kernel"),
                                   graph_ms=cs_.graph_ms(floor))
    for label, r in row.items():
        print(f"compact tile=1024 {label:12s} " + " ".join(f"{key}={v}" for key, v in r.items()),
              flush=True)
    results["compact[tile=1024]"] = row
    return results


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_kernel_ab.py needs a GPU")
    import chip_smoke as cs_
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.geom import cluster as clmod
    from pbrt_tpu_torch.geom import scene as scenemod
    from pbrt_tpu_torch.integrate import ao, direct, driver
    from pbrt_tpu_torch.kernels import cluster_cuda as kern
    from pbrt_tpu_torch.scenes import bench_camera, bench_scene

    args, reps, res, probes_only = [], 20, 512, False
    it = iter(sys.argv[1:])
    for a in it:
        if a == "--reps":
            reps = int(next(it))
        elif a == "--res":
            res = int(next(it))
        elif a == "--probes":
            probes_only = True
        else:
            args.append(a.split("=", 1))
    if not args:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print("card:", smi, flush=True)
    out_dir = os.path.join(os.path.dirname(kern.library_path()), "ab")
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    jobs = [(label, *build(label, spec, out_dir, kern.NVCC_FLAGS, kern._nvcc()))
            for label, spec in args]
    libs, usage = {}, {}
    for label, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode:
            sys.exit(f"nvcc failed for {label}:\n{err}")
        libs[label] = load(so)
        usage[label] = kern.ptxas_usage(err)
        print(f"{label}: registers, spill store bytes {usage[label]}", flush=True)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    if probes_only:
        results = probe_ab(libs, reps)
        print(json.dumps({"card": smi, "reps": reps, "builds": dict(args), "usage": usage,
                          "results": results}), flush=True)
        return

    dev = torch.device("cuda")
    scene = bench_scene(6, dev)
    cs = scene.clusters
    tile = scene.tile
    cam = bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    pid, sid = driver.lane_ids(cfg, 0, 1, dev)
    o, d, _, _ = driver.camera_rays(cam, cfg, pid.reshape(-1), sid.reshape(-1))
    n = o.shape[0]
    t_min = torch.full((n,), 1e-4, device=dev)
    t_max = torch.full((n,), float("inf"), device=dev)
    _, rays_p, _ = clmod.prepare(cs, o, d, t_min, t_max, tile)
    hit = scenemod.intersect(scene, o, d)
    ob, db, tminb, tmaxb, flag = cs_.bounce_wavefront(scene, o, d, hit)
    _, rays_b, flag_s = clmod.prepare(cs, ob, db, tminb, tmaxb, tile, flag)
    sent_d = cs_.sent_wavefronts(clmod, lambda: driver.render_lanes(
        scene, cam, cfg, direct.make_li(cfg, "one"), pid, sid))
    sent_a = cs_.sent_wavefronts(clmod, lambda: driver.render_lanes(
        scene, cam, cfg, ao.make_li(cfg, True, 4), pid, sid))
    rays_d, rays_a = (clmod.prepare(cs, *w[0], tile)[1] for w in (sent_d, sent_a))
    shapes = [(tag, "coverage", rays, None) for tag, rays in (
        ("primary", rays_p), ("fused_bounce", rays_b), ("direct_shadow", rays_d),
        ("ao", rays_a))]
    shapes += [("primary", "closest", rays_p, None), ("fused_bounce", "closest", rays_b, flag_s),
               ("direct_shadow", "occluded", rays_d, None), ("ao", "occluded", rays_a, None)]

    P = lambda x: ctypes.c_void_p(0 if x is None else x.data_ptr())   # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    results = {}
    for tag, kind, rays, fl in shapes:
        nt = rays.shape[1] // tile
        corder, tnear, counts, covbits = clmod.tile_cluster_order(cs, rays, tile)
        W, nb32, k = corder.shape[1], covbits.shape[1], cs.packed.shape[2]
        if kind == "coverage":
            cpad = cs.bounds.shape[1]
            nlt = torch.tensor([-(-int((rays[7] > rays[6]).sum()) // tile)],
                               dtype=torch.int32, device=dev)
            outs = lambda: (torch.empty((nt, cpad), device=dev),   # noqa: E731
                            torch.empty((nt, nb32, tile), dtype=torch.int32, device=dev))

            def call(lib, out, st=None, nd=None):
                if st is not None and hasattr(lib, "pbrt_coverage_counted"):
                    return lib.pbrt_coverage_counted(P(rays), P(cs.bounds), P(nlt), P(out[0]),
                                                     P(out[1]), P(st), P(nd), nt, tile, cpad,
                                                     cs.n_clusters, stream)
                return lib.pbrt_coverage(P(rays), P(cs.bounds), P(nlt), P(out[0]), P(out[1]),
                                         nt, tile, cpad, cs.n_clusters, stream)
        elif kind == "closest":
            outs = lambda: (torch.empty((nt, tile), device=dev),   # noqa: E731
                            torch.empty((nt, tile), dtype=torch.int32, device=dev),
                            torch.empty((nt, 2, tile), device=dev))

            def call(lib, out, st=None, nd=None):
                return lib.pbrt_closest(P(cs.packed), P(rays), P(fl), P(corder), P(tnear),
                                        P(counts), P(covbits), *(P(x) for x in out), P(st),
                                        P(nd), nt, tile, W, nb32, k, kern.CH, stream)
        else:
            outs = lambda: (torch.empty((nt, tile), dtype=torch.bool, device=dev),)  # noqa: E731

            def call(lib, out, st=None, nd=None):
                return lib.pbrt_occluded(P(cs.packed), P(rays), P(corder), P(counts),
                                         P(covbits), P(out[0]), P(st), P(nd), nt, tile, W,
                                         nb32, k, kern.CH, stream)
        ref, row = None, {}
        for label, lib in libs.items():
            out = outs()
            st, nd = (torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(2))
            if call(lib, out, st, nd):
                sys.exit(f"{label} {kind} launch failed")
            torch.cuda.synchronize()
            ref = ref or out
            if kind == "coverage":
                counted = hasattr(lib, "pbrt_coverage_counted")
                row[label] = dict(tests_run=int(st) if counted else None,
                                  tests_needed=int(nd) if counted else None,
                                  covbit_words_differ=int((out[1] != ref[1]).sum()),
                                  tnear_differ=int((out[0] != ref[0]).sum()), ms=[])
            else:
                i = -1 if kind == "occluded" else 1
                row[label] = dict(slot_tests=int(st), needed_tests=int(nd),
                                  lanes_differ=int((out[i] != ref[i]).sum()), ms=[])
        out = outs()
        for label, ms in timed_in_turns(libs, lambda lb: call(libs[lb], out), reps).items():
            row[label]["ms"] = ms
        for label, r in row.items():
            print(f"{tag:14s} {kind:8s} {label:12s} "
                  + " ".join(f"{key}={v}" for key, v in r.items()), flush=True)
        results[f"{kind}[{tag}]"] = row
    print(json.dumps({"card": smi, "reps": reps, "res": res, "builds": dict(args),
                      "usage": usage, "results": results}), flush=True)


if __name__ == "__main__":
    main()
