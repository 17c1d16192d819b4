"""Run one cell of the benchmark of pbrt_tpu_torch once, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads and warms up the cell's configuration and traffic (set-up), runs a
closed loop for --seconds (or, with --trace 1, profiles a few frames or
steps for the per-layer metrics), compares what the timed path produced
with the plain reference, and prints one JSON object as the last line of
standard output. Exits non-zero, printing no result, without enough CUDA
cards, when the run breaks (the port missing, say), or when a module of
JAX or of pbrt_tpu was loaded."""
import time

_T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def process_start():
    """When this process started, by the clock of time.time()."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _T0


def cache_dirs():
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = os.path.join(HERE, ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    started = process_start()
    cache_dirs()
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch
    from pbench import check, guard, manifest
    from pbench.runner import Run

    cell = manifest.cell(manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    run = Run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", ROOT, started)
    run.execute()
    if run.error:               # a run that broke prints no result
        print(run.error, file=sys.stderr)
        return 5
    bad = guard.banned_modules()
    if bad:
        print(f"modules that a run may not load were loaded: {bad}", file=sys.stderr)
        return 4
    res = run.result()
    print(f"card {res['card']}", file=sys.stderr)
    check.say(run.compared)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
