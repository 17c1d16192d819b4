"""The traced run's device trace: torch.profiler over a few steady frames
or steps, read into plain lists of intervals in seconds."""
from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from . import stats

MARK = "bench:"        # prefix of the harness's own spans in the trace


class Trace(NamedTuple):
    device: list        # (name, start_s, end_s) of every device activity
    host: list          # (name, start_s, end_s) of host ops and harness spans
    spans: dict         # harness span name -> [(start_s, end_s)], profiler time

    def kernels(self):
        """Device activities that are kernels, not copies or sets."""
        return [k for k in self.device if not k[0].startswith(("Memcpy", "Memset"))]

    def window(self, span):
        """(start, end) of the harness spans named `span`, first to last."""
        iv = self.spans[span]
        return min(s for s, _ in iv), max(e for _, e in iv)


class Spans:
    """The harness's own spans: host-clock (start, end) per name, and in a
    traced run a record_function mark the trace can place. Off unless
    `on`, so untraced runs pay nothing."""

    def __init__(self, on, sync=None):
        self.on, self.sync = on, sync
        self.times = {}

    @contextlib.contextmanager
    def __call__(self, name, sync=False):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        with torch.profiler.record_function(MARK + name):
            yield
            if sync:
                self.sync()
        self.times.setdefault(name, []).append((t0, time.perf_counter()))

    def seconds(self, name):
        return sum(e - s for s, e in self.times.get(name, ()))


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def read(prof):
    """The profiler's events as a Trace. A device event is one whose
    device type is CUDA; the harness's marks are left out of the device
    list (the profiler may mirror them on the device's timeline)."""
    dev, host, spans = [], [], {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        iv = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.name.startswith(MARK):
            if e.device_type != cuda:
                spans.setdefault(e.name[len(MARK):], []).append(iv[1:])
                host.append(iv)
        elif e.device_type == cuda:
            dev.append(iv)
        else:
            host.append(iv)
    return Trace(dev, host, spans)


def busy_seconds(tr, lo, hi):
    return stats.union_seconds([(s, e) for _, s, e in tr.device], lo, hi)


def short(name, n=160):
    """A kernel's name without its return type and common namespaces, cut
    to n characters."""
    for a, b in (("void ", ""), ("at::native::", ""), ("(anonymous namespace)::", ""),
                 ("at::", "")):
        name = name.replace(a, b)
    return name[:n]


def top_device_ops(tr, lo, hi, n=10):
    """The n device operations by total time in [lo, hi]: [[name, s]]."""
    tot = {}
    for name, s, e in tr.device:
        if s >= lo and e <= hi:
            tot[short(name)] = tot.get(short(name), 0.0) + (e - s)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _label(tr, t):
    """What the host was doing at time t: the innermost harness span and
    the innermost other host op in progress."""
    span = op = None
    for name, s, e in tr.host:
        if s <= t < e:
            if name.startswith(MARK):
                if span is None or e - s < span[1]:
                    span = (name[len(MARK):], e - s)
            elif op is None or e - s < op[1]:
                op = (name, e - s)
    parts = [p[0] for p in (span, op) if p is not None]
    return " > ".join(parts) if parts else "no host op"


def idle_gaps(tr, lo, hi, n=10):
    """The n longest idle gaps of the device in [lo, hi], each named by
    what the host was doing when it began: [[label, s]]."""
    g = sorted(stats.gaps([(s, e) for _, s, e in tr.device], lo, hi),
               key=lambda iv: iv[0] - iv[1])[:n]
    return [[_label(tr, s), e - s] for s, e in g]
