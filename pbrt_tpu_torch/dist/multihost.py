"""Multi-process entry on torch.distributed (counterpart of
pbrt_tpu/dist/multihost.py; baseline config 5).

`ensure_initialized` joins the processes into one process group over TCP;
after it, `sharding.make_mesh()` spans every rank and the sharded render
and train step run across them unchanged. Nothing tells a program of a
cluster: the caller names the coordinator, the world size and the rank.

A 2-process weak-scaling run, one command per process:

    python -m pbrt_tpu_torch.dist.multihost --coordinator host0:29500 \\
        --num-processes 2 --process-id 0     # and --process-id 1 on the other

Environment fallbacks: PBRT_TPU_COORDINATOR, PBRT_TPU_NUM_PROCESSES,
PBRT_TPU_PROCESS_ID. The backend follows the device: NCCL on cuda (one
card per process, the card of index rank % cards), gloo on the CPU.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

from .. import resolve_device
from . import sharding


def ensure_initialized(coordinator=None, num_processes=None, process_id=None, device=None):
    """Idempotent process-group init: with several processes or a
    coordinator given, init_process_group(init_method="tcp://coordinator")
    on the device's backend; a single process is a no-op. Returns
    (world size, rank)."""
    coordinator = coordinator or os.environ.get("PBRT_TPU_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PBRT_TPU_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PBRT_TPU_PROCESS_ID", "0"))
    if not dist.is_initialized() and (num_processes > 1 or coordinator):
        if not coordinator:
            raise ValueError(f"{num_processes} processes need a coordinator host:port")
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(process_id % torch.cuda.device_count())
        dist.init_process_group(sharding.BACKEND[dev.type], init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def shutdown():
    """Wait for every rank, then destroy the process group, if there is
    one. Hold no ProcessGroup object past this (sharding.Mesh holds none):
    the group is then destructed here and not in the interpreter's
    teardown, where gloo processes abort now and then."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def weak_scaling_bench(res=256, spp=4, depth=5, device=None):
    """Per-process throughput of the weak-scaling run: each rank renders
    its shard of a bench-scene frame, so adding a process adds lanes at
    constant work per rank. Returns the frame's wall seconds."""
    from ..core import samplers as smp
    from ..integrate import driver, path
    from ..scenes import bench_camera, bench_scene

    dev = resolve_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        dev = torch.device("cuda", torch.cuda.current_device())
    nproc, pid = ensure_initialized(device=dev)
    mesh = sharding.make_mesh()
    scene = bench_scene(6, dev)
    camera = bench_camera((res, res), dev)
    cfg = driver.RenderConfig(width=res, height=res, spp=spp, max_depth=depth,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))
    li = path.make_li(cfg, camera=camera)
    sharding.render_sharded(scene, camera, cfg, li, mesh=mesh)     # warm-up
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = sharding.render_sharded(scene, camera, cfg, li, mesh=mesh)
    float(img.sum())
    dt = time.perf_counter() - t0
    rays = res * res * spp * (2 * depth + 1)
    if pid == 0:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"processes={nproc} device={name} wall={dt * 1e3:.1f}ms "
              f"upper-bound-rays={rays} ({rays / dt / 1e6:.2f} Mrays/s aggregate)", flush=True)
    return dt


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    ensure_initialized(args.coordinator, args.num_processes, args.process_id, args.device)
    try:
        weak_scaling_bench(res=args.res, device=args.device)
    finally:
        shutdown()


if __name__ == "__main__":
    main()
