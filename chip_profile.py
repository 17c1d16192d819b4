#!/usr/bin/env python3
"""Where the time of one frame goes, on the GPU.

    python3 chip_profile.py [path|direct|ao|cornell|volpath|volpath_bench_fog|
                             volpath_smoke|whitted|grad ...]

Renders the bench frames of chip_smoke.py (512×512, 1 spp, zerotwo; path
at depth 5 with compact_from=1, direct lighting with strategy "one",
ambient occlusion with 4 cosine samples; path alone by default), or
`cornell`, baseline config 2 (the Cornell box with a mirror and a glass
sphere, path at depth 5 with compact_from=1, 256×256 at 64 spp in
wavefronts of pbrt_tpu_torch.scenes.CORNELL_SPP_BATCH samples), or
`volpath`, baseline config 4 (the fog box, volpath at depth 5, 512×512 at
4 spp in one wavefront, zerotwo), `volpath_bench_fog` and `volpath_smoke`
(the bench scene in fog and the smoke box, 512×512, 1 spp), or `whitted`
(config 2's box, Whitted at depth 5, 256×256 at 16 spp in one wavefront),
through pbrt_tpu_torch: for each, one warm-up, three frames timed with the host
clock around torch.cuda.synchronize(), then one frame under
torch.profiler. Prints the frame time, the device-busy share (sum of GPU
kernel time over the profiled frame's wall time), the time of the CUDA
tracing kernels (coverage's two passes each and together), the count of
GPU kernel launches, and the top ops by device time and by count.
`grad` is baseline config 5 at the bench scene's width: one training
step (dist.sharding's, one rank) of the bench path frame with the white
walls' and the blob's kd and the light's emit perturbed; three steps
timed in their forward and backward halves, then each half under its own
profile, with the same figures for each.
Needs a GPU; prints the card's name and power limit.
"""
import subprocess
import sys
import time


FRAMES = 3


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_profile.py needs a GPU")
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.integrate import ao, direct, driver, path, volpath, whitted
    from pbrt_tpu_torch.kernels import cluster_cuda as kern
    from pbrt_tpu_torch.scenes import (CORNELL_RES, CORNELL_SPP, CORNELL_SPP_BATCH,
                                       bench_camera, bench_fog_scene, bench_scene,
                                       cornell_camera, cornell_spheres, fog_scene,
                                       smoke_scene, volumetric_camera)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print("card:", smi, flush=True)
    dev = torch.device("cuda")
    kern.load_library()
    names = sys.argv[1:] or ["path"]
    frames = {}
    if set(names) & {"path", "direct", "ao"}:
        scene = bench_scene(6, dev)
        res = 512
        cam = bench_camera((res, res), dev)
        cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                                  sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
        pid, sid = driver.lane_ids(cfg, 0, 1, dev)
        for name, li in (("path", path.make_li(cfg, camera=cam, compact_from=1,
                                               return_stats=True)),
                         ("direct", direct.make_li(cfg, "one", return_stats=True)),
                         ("ao", ao.make_li(cfg, True, 4, return_stats=True))):
            frames[name] = (lambda li=li: driver.render_lanes(scene, cam, cfg, li, pid,
                                                              sid)[0])
    if "cornell" in names:
        cscene = cornell_spheres(True, "area", dev)
        ccam = cornell_camera((CORNELL_RES, CORNELL_RES), dev)
        ccfg = driver.RenderConfig(width=CORNELL_RES, height=CORNELL_RES, spp=CORNELL_SPP,
                                   max_depth=5, samples_per_batch=CORNELL_SPP_BATCH,
                                   sampler=smp.SamplerConfig(kind="zerotwo", spp=CORNELL_SPP))
        cli = path.make_li(ccfg, camera=ccam, compact_from=1, return_stats=True)
        frames["cornell"] = lambda: driver.render(cscene, ccam, ccfg, cli)

    def volpath_frame(scene, cam, spp):
        cfg = driver.RenderConfig(width=512, height=512, spp=spp, max_depth=5,
                                  sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
        li = volpath.make_li(cfg, return_stats=True)
        return lambda: driver.render(scene, cam, cfg, li)

    for name, make in (("volpath", lambda: (fog_scene(device=dev), volumetric_camera, 4)),
                       ("volpath_bench_fog", lambda: (bench_fog_scene(6, dev), bench_camera, 1)),
                       ("volpath_smoke", lambda: (smoke_scene(device=dev), volumetric_camera, 1))):
        if name in names:
            vscene, vcam, vspp = make()
            frames[name] = volpath_frame(vscene, vcam((512, 512), dev), vspp)
    if "whitted" in names:
        wscene = cornell_spheres(True, "area", dev)
        wcam = cornell_camera((256, 256), dev)
        wcfg = driver.RenderConfig(width=256, height=256, spp=16, max_depth=5,
                                   sampler=smp.SamplerConfig(kind="zerotwo", spp=16))
        wli = whitted.make_li(wcfg, return_stats=True)
        frames["whitted"] = lambda: driver.render(wscene, wcam, wcfg, wli)
    for name in names:
        if name == "grad":
            profile_grad(torch, dev)
        else:
            profile_frame(torch, name, frames[name])


def profile_grad(torch, dev):
    """Config 5's training step on the bench frame, forward and backward
    timed and profiled apart."""
    from torch.profiler import ProfilerActivity, profile
    from pbrt_tpu_torch.core import samplers as smp
    from pbrt_tpu_torch.diff import demo
    from pbrt_tpu_torch.dist import sharding
    from pbrt_tpu_torch.integrate import driver, path
    from pbrt_tpu_torch.scenes import bench_camera, bench_scene

    res = 512
    cam = bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=1, max_depth=5,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=1))
    li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)
    step, sc, target = demo.training(bench_scene(6, dev), cam, cfg, li, demo.perturbed_bench,
                                     sharding.make_mesh(1))

    def halves():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, stats = step.forward(sc, cam, target)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step.backward(loss, params)
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, float(stats["rays_traced"])

    halves()
    times = [halves() for _ in range(FRAMES)]
    rays = times[-1][2]
    fb = [f + b for f, b, _ in times]
    print(f"[grad] forward_ms={[round(f, 3) for f, _, _ in times]} "
          f"backward_ms={[round(b, 3) for _, b, _ in times]} rays_per_step={rays:.0f} "
          f"mrays_per_s_fwd_bwd={rays / (sum(fb) / len(fb) / 1e3) / 1e6:.3f}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_f:
        t0 = time.perf_counter()
        loss, params, _ = step.forward(sc, cam, target)
        torch.cuda.synchronize()
        wall_f = (time.perf_counter() - t0) * 1e3
    report(torch, "grad_forward", prof_f, wall_f)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_b:
        t0 = time.perf_counter()
        step.backward(loss, params)
        torch.cuda.synchronize()
        wall_b = (time.perf_counter() - t0) * 1e3
    report(torch, "grad_backward", prof_b, wall_b)
    print(f"[grad] peak_memory_bytes={torch.cuda.max_memory_allocated()}", flush=True)


def profile_frame(torch, name, frame):
    """frame() renders one frame and returns (image, stats)."""
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    times = []
    for _ in range(FRAMES):
        t0 = time.perf_counter()
        _, stats = frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    rays = float(stats["rays_traced"])    # each integrator counts its own
    print(f"[{name}] frame_ms={[round(t, 3) for t in times]} rays_per_frame={rays:.0f} "
          f"mrays_per_s={rays / (sum(times) / len(times) / 1e3) / 1e6:.3f}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report(torch, name, prof, wall_ms)


def report(torch, name, prof, wall_ms):
    """The device-busy share, the tracing kernels' device time, the GPU
    launches and the top ops of one profiled stretch."""
    events = prof.events()
    dev_kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in dev_kernels) / 1e3
    ours = {}
    for e in dev_kernels:
        for k in ("coverage_lanes_kernel", "coverage_columns_kernel", "closest_kernel",
                  "occluded_kernel"):
            if k in e.name:
                c = ours.setdefault(k, [0, 0.0])
                c[0] += 1
                c[1] += e.device_time / 1e3
    print(f"[{name}] profiled_frame_wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
          f"device_busy_share={busy_ms / wall_ms:.4f} gpu_kernel_launches={len(dev_kernels)}",
          flush=True)
    for k, (n, ms) in ours.items():
        print(f"[{name}] {k}: launches={n} device_ms={ms:.3f}", flush=True)
    cov = [v for k, v in ours.items() if k.startswith("coverage")]
    print(f"[{name}] coverage (both passes): launches={cov[0][0] if cov else 0} "
          f"device_ms={sum(ms for _, ms in cov):.3f}", flush=True)
    averages = prof.key_averages()
    print(averages.table(sort_by="self_device_time_total", row_limit=40), flush=True)
    print(averages.table(sort_by="count", row_limit=30), flush=True)


if __name__ == "__main__":
    main()
