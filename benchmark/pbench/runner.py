"""One run of one cell: what every traffic kind shares. The traffic's
`kind` names the module that drives it (render.py, train.py); the run
collects set-up time, the window's times, memory, the traced readings and
the comparison, and makes the result line."""
from __future__ import annotations

import gc
import importlib
import math
import subprocess
import time
import traceback

import torch

from . import check, manifest, stats, trace

GIB = float(1 << 30)


class Readings:
    """What a per-layer reader reads: the trace of the profiled frames or
    steps, the harness's spans, and the roofline summaries."""

    def __init__(self, run, tr, item, n, roof):
        self.run, self.trace, self.item, self.n = run, tr, item, n
        self.spans = run.spans
        self.scene_build_s = run.scene_build_s
        self.untraced_s = run.untraced_item_s
        self.lo, self.hi = tr.window(item) if item in tr.spans else (0.0, 0.0)
        self._roof = roof or {}

    def kernels(self):
        """(name, start, end) of the kernels within the profiled window."""
        return [k for k in self.trace.kernels() if k[1] >= self.lo and k[2] <= self.hi]

    def kernel_seconds(self, pred):
        return sum(e - s for name, s, e in self.kernels() if pred(name))

    def busy_s(self):
        return trace.busy_seconds(self.trace, self.lo, self.hi)

    def window_s(self):
        return self.hi - self.lo

    def roofline(self, kind):
        """Least time, ops, bytes and bound of the tracer's calls of `kind`
        ("closest" or "occluded") in the profiled frames, or None."""
        return self._roof.get(kind)


class Run:
    def __init__(self, cell_name, seed, seconds, traced, device="cuda", root=manifest.ROOT,
                 process_start=None, overrides=None):
        self.man = manifest.load(root)
        self.cell = manifest.cell(self.man, cell_name)
        self.name = cell_name
        self.conf_entry, self.conf = manifest.config(self.man, self.cell["config"], root)
        self.traffic = manifest.traffic(self.cell["traffic"])
        self.traffic.update((overrides or {}).get("traffic", {}))    # smaller shapes in tests
        self.seed, self.seconds, self.trace = seed, seconds, traced
        self.device = torch.device(device)
        self.process_start = time.time() if process_start is None else process_start
        self.spans = trace.Spans(traced, self.sync)
        self.scene_build_s = None
        self.untraced_item_s = None       # a traced run's frame or step, untraced
        self.e2e, self.layer = {}, {}
        self.memory_peak = 0
        self.correct, self.compared, self.attempted, self.failed = False, {}, 0, 0
        self.device_info = {}
        self.breakdown = None
        self.clock = {}
        self.error = None

    # ---- what the traffic drivers call
    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def end_setup(self):
        self.sync()
        gc.collect()
        gc.freeze()         # the set-up's objects leave the collector's scans
        if self.device.type == "cuda":
            self.setup_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        self.e2e["setup_s"] = time.time() - self.process_start
        self.clock["setup"] = time.time() - self.process_start

    def window(self, window_s, times):
        """The untraced window: its length and every item's time."""
        item_ms = stats.per_item_ms(window_s, len(times))
        self.e2e["frame_ms"] = self.e2e["step_ms"] = item_ms
        self.e2e["frame_p90_ms"] = 1e3 * stats.percentile(times, 90)
        self.clock["window"] = window_s
        self.clock["items"] = len(times)
        self.clock["item_ms_min_median_max"] = [1e3 * min(times), 1e3 * stats.percentile(times, 50),
                                                1e3 * max(times)]

    def read_memory(self):
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated()
            self.e2e["peak_mem_gib"] = peak / GIB
            self.memory_peak = max(peak, self.setup_peak)

    def untraced_items(self, one, n):
        """Before the profile: n frames or steps by `one()`, untraced, their
        mean wall time on the host clock."""
        t0 = time.perf_counter()
        for _ in range(n):
            one()
        self.sync()
        self.untraced_item_s = (time.perf_counter() - t0) / n

    def traced(self, tr, item, n, roof):
        """The per-layer metrics of the cell, each from its reader; `roof`
        the roofline summaries of the profiled frames, or None."""
        r = Readings(self, tr, item, n, roof)
        for m in manifest.metrics(self.man, self.name, "per_layer"):
            v = manifest.reader(m["name"]).read(r)
            if v is not None:
                self.layer[m["name"]] = v
        self.device_info.update(busy_s=r.busy_s(), window_s=r.window_s())
        self.breakdown = {"device_ops": trace.top_device_ops(tr, r.lo, r.hi),
                          "idle_gaps": trace.idle_gaps(tr, r.lo, r.hi)}
        self.roofline_notes = roof

    def judge(self, numbers, attempted):
        self.clock["check"] = time.time() - self.process_start - self.clock["setup"] \
            - self.clock.get("window", 0.0)
        self.correct, self.compared = check.judge(numbers, check.limits(self.name))
        self.attempted, self.failed = attempted, 0 if self.correct else 1

    # ---- the run and its result line
    def execute(self):
        mod = importlib.import_module(f"pbench.{self.traffic['kind']}")
        try:
            mod.execute(self)
        except Exception:            # a run that breaks is reported, not hidden
            self.error = traceback.format_exc()
            self.correct = False

    def result(self):
        kind = "per_layer" if self.trace else "end_to_end"
        wanted = manifest.metrics(self.man, self.name, kind)
        metrics = {}
        for m in wanted:
            v = (self.layer if self.trace else self.e2e).get(m["name"])
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if self.device.type == "cuda" else self.device.type,
               "kind": torch.cuda.get_device_name(0) if self.device.type == "cuda" else "cpu",
               "count": int(self.cell["chips"]), "memory_peak_bytes": int(self.memory_peak)}
        dev.update(self.device_info)
        out = {"correct": bool(self.correct and self.error is None),
               "attempted": self.attempted, "failed": self.failed, "metrics": metrics,
               "device": dev}
        if self.breakdown is not None:
            out["breakdown"] = self.breakdown
        if self.trace and getattr(self, "roofline_notes", None):
            out["roofline"] = self.roofline_notes
        out["card"] = power_limit() if self.device.type == "cuda" else None
        out["seconds"] = self.clock
        out["compared"] = self.compared
        return out


def power_limit():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"

