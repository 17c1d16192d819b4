"""Readings that set a cell's limits, in one process on the card: for
each seed, the numbers the comparison gives for the port's frame (or
first training steps), for the control (the reference in bfloat16, in
the port's place) and, with --faults, for each planted fault.

    python3 benchmark/readings.py --workload <cell> --seeds 11,12,13 [--control] [--faults]

Prints one JSON line a seed and reading. The port's frames go through
the timed call (`driver.render`, `TrainStep.__call__`) with the run's
own seeds (frame 0 of the seed)."""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def render_readings(run, seeds, control, faults):
    from pbench import check, faults as fl, render
    from pbench.pkg import frame_seed
    from pbench.reference import Renderer
    port = render.Port(run)
    port.frame(frame_seed(0, "warmup"))
    ref = Renderer(run.conf, run.traffic, run.device)
    for seed in seeds:
        fs = frame_seed(seed, "frame", 0)
        t0 = time.perf_counter()
        img = port.frame(fs).cpu()
        t1 = time.perf_counter()
        r = ref.frame(fs)
        t2 = time.perf_counter()
        yield {"seed": seed, "reading": "port", **check.image_numbers(img, r),
               "port_s": t1 - t0, "reference_s": t2 - t1}
        if control:
            yield {"seed": seed, "reading": "control",
                   **check.image_numbers(ref.frame(fs, lowp=True), r)}
        for name in (fl.RENDER if faults else ()):
            with fl.RENDER[name]():
                if name == "unchanged":       # the first frame stands for every later one
                    port.frame(frame_seed(seed, "frame", 1))
                bad = port.frame(fs).cpu()
            yield {"seed": seed, "reading": f"fault_{name}", **check.image_numbers(bad, r)}


def train_readings(run, seeds, control, faults):
    from pbench import faults as fl, train
    from pbench.reference import free_device
    n, lr = run.traffic["checked_steps"], run.traffic["lr"]
    for seed in seeds:
        run.seed = seed
        t0 = time.perf_counter()
        prog = train.checked_steps(train.Port(run), n)
        t1 = time.perf_counter()
        free_device()
        ref = train.reference_steps(run.conf, run.traffic, run.device, seed, n)
        t2 = time.perf_counter()
        yield {"seed": seed, "reading": "port", **train.numbers(prog, ref, lr),
               "port_s": t1 - t0, "reference_s": t2 - t1}
        if control:
            ctl = train.reference_steps(run.conf, run.traffic, run.device, seed, n, lowp=True)
            yield {"seed": seed, "reading": "control", **train.numbers(ctl, ref, lr)}
        for name in (fl.TRAIN if faults else ()):
            with fl.TRAIN[name]():
                bad = train.checked_steps(train.Port(run), n)
            free_device()
            yield {"seed": seed, "reading": f"fault_{name}", **train.numbers(bad, ref, lr)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}", help='JSON: {"traffic": {...}} (tests)')
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    sys.path.insert(1, ROOT)
    import torch
    from pbench.runner import Run
    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings need a CUDA card", file=sys.stderr)
        return 3
    run = Run(args.workload, 0, 0.0, False, args.device, ROOT,
              overrides=json.loads(args.overrides))
    seeds = [int(s) for s in args.seeds.split(",")]
    fn = train_readings if run.traffic["kind"] == "train" else render_readings
    for row in fn(run, seeds, args.control, args.faults):
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
