"""The profiled frames' device time, launches and idle gaps put down to
the port's layers, from the port's own spans (pbrt_tpu_torch/trace.py).

The port records its spans in memory on the host clock
(time.perf_counter_ns) while the profiler records; the trace's clock is
the profiler's. The harness's `render` span is on both: its host times
(Spans.times, the same clock as the port's) and its mark in the trace.
Each frame's port `driver.render` must lie inside one harness `render`
span on the host clock; the frame's port spans are then moved onto the
trace's clock by the offset between that span and its mark. The mark is
entered after the host clock is read and left before it is read again,
so the offset lies between the offsets of their ends and of their starts
(tens of microseconds apart with the profiler on, more on a busy host);
the runtime calls inside the mark, all issued inside `driver.render`,
narrow it further (`align`).

Device activities are paired with the host runtime calls that issued
them by issue order on the one stream (kernels with launch calls, copies
with copy calls, sets with set calls); where the profile lost device
records, the calls left without one are placed by timing (`pair`). The
device's clock is off the host's in a profile by tens of microseconds,
drifting from frame to frame, so each frame's device times are moved
onto the host's clock by the least delay from a call to its activity's
start. A kernel is put down to the innermost port span open when its
launch call began; an idle gap of the device inside a frame to the
innermost port span open when the gap began. A span's layer is its name
up to the first dot. Kernels issued and gaps begun outside every port
span are the harness's and count for no layer.

`of(r)` computes this once per Readings and returns None, so that every
metric over it is left out, where the port records no spans (a port
without pbrt_tpu_torch/trace.py), where the port `driver.render` span of
a profiled frame does not fall inside a harness `render` span, or where
a device activity of the window pairs with no issuing call (`pair`)."""
from __future__ import annotations

import bisect
import importlib
from typing import NamedTuple

from . import stats
from .pkg import PORT

LAYERS = ("sampler", "shading", "lights", "compaction", "tracer", "driver")
ROOT = "driver.render"       # the port's span of one frame
HARNESS = "render"           # the harness's span around the call into it
ISSUING = {"launch": ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel"),
         "copy": ("cudaMemcpy", "cuMemcpy"),
         "set": ("cudaMemset", "cuMemset")}


class Layers(NamedTuple):
    launches: dict      # layer -> kernels over the frames
    device_s: dict      # layer -> kernel seconds over the frames
    idle_s: dict        # layer -> idle seconds inside the frames
    counters: dict      # the port's counters of the frames' requests
    outside: int        # kernels issued outside every port span
    frames: int


def layer(name):
    return name.split(".", 1)[0]


def issue_kind(name):
    for kind, prefixes in ISSUING.items():
        if name.startswith(prefixes):
            return kind
    return None


def device_kind(name):
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return "launch"


def port_records():
    """(records, counters(requests)) of the port's tracer, or None where
    the port has none."""
    try:
        mod = importlib.import_module(f"{PORT}.trace")
    except ImportError:
        return None
    return mod.records(), mod.counters


def align(records, host_spans, marks, calls=()):
    """Each profiled frame: (offset s, the frame's records) with the
    offset that takes its host times to the trace's clock, from the
    harness `render` span that holds its root on the host clock and that
    span's mark, the k-th holding span with the k-th mark. The profiled
    frames' roots are those that meet a harness `frame` span (host clock).
    The mark bounds the offset (module doc); so do the issuing calls
    `calls` (trace clock, sorted) inside the mark, which the port's
    `driver.render` holds, the harness's span holding that call alone: the
    offset is the middle of the range both allow, or where they disagree
    the point of the calls' range nearest the mark's middle. None where
    such a root lies in no `render` span, the spans holding roots are not
    as many as the marks, or a frame's calls span more than its root."""
    frames = host_spans.get("frame", ())
    roots = sorted((r for r in records if r.parent is None and r.name == ROOT
                    and r.end_ns is not None
                    and any(f0 < r.end_ns * 1e-9 and r.start_ns * 1e-9 < f1
                            for f0, f1 in frames)), key=lambda r: r.start_ns)
    host = sorted(host_spans.get(HARNESS, ()))
    marks = sorted(marks)
    held = []
    for r in roots:
        s, e = r.start_ns * 1e-9, r.end_ns * 1e-9
        inside = [h for h in host if h[0] <= s and e <= h[1]]
        if len(inside) != 1:
            return None
        held.append(inside[0])
    if not roots or len(set(held)) != len(held) or len(held) != len(marks):
        return None
    by_request = {}
    for r in records:
        if r.end_ns is not None:
            by_request.setdefault(r.request, []).append(r)
    out = []
    for r, (h0, h1), (p0, p1) in zip(roots, held, marks):
        rs, re = r.start_ns * 1e-9, r.end_ns * 1e-9
        a_lo, a_hi = sorted((p1 - h1, p0 - h0))          # the mark's range
        i, j = bisect.bisect_left(calls, p0), bisect.bisect_right(calls, p1)
        b_lo, b_hi = (calls[j - 1] - re, calls[i] - rs) if j > i else (a_lo, a_hi)
        if b_lo > b_hi:
            return None
        lo, hi = max(a_lo, b_lo), min(a_hi, b_hi)
        off = 0.5 * (lo + hi) if lo <= hi else min(max(0.5 * (a_lo + a_hi), b_lo), b_hi)
        out.append((off, by_request[r.seq]))
    return out


def timeline(frames):
    """(breakpoints, owners): owners[i] is the innermost span's name over
    [breakpoints[i], breakpoints[i + 1]), None outside every span."""
    bps, owners = [], []
    for off, recs in frames:
        events = []
        for r in recs:
            events.append((r.start_ns * 1e-9 + off, 1, r.seq, r.name))
            events.append((r.end_ns * 1e-9 + off, 0, r.seq, r.name))
        events.sort()             # at one instant, ends before starts
        stack = []
        for t, is_start, seq, name in events:
            if is_start:
                stack.append((seq, name))
            else:
                stack.remove(next(x for x in stack if x[0] == seq))
            top = stack[-1][1] if stack else None
            if bps and bps[-1] == t:
                owners[-1] = top
            else:
                bps.append(t)
                owners.append(top)
    return bps, owners


def owner(tl, t):
    bps, owners = tl
    i = bisect.bisect_right(bps, t) - 1
    return owners[i] if i >= 0 else None


def _offset(calls, dev):
    """The device clock's offset from the host's: the least (activity
    start - call start) over the pairs in order up to the first kind that
    differs, so the quickest start after its call reads 0."""
    lat = []
    for c, d in zip(calls, dev):
        if issue_kind(c[0]) != device_kind(d[0]):
            break
        lat.append(d[1] - c[1])
    return min(lat) if lat else None


def _place_lost(calls, dev, off, lost):
    """Indices into `calls` of the activities `dev` (in order) where
    `lost` of the calls have no record: of the orders that
    match every kind, the one whose activities start closest to when each
    could first have started (its call, or the previous activity's end,
    whichever is later, on the host's clock). None where no order matches
    the kinds."""
    inf = float("inf")
    cost = [0.0] * (lost + 1)
    back = []
    for k, d in enumerate(dev):
        ready_prev = dev[k - 1][2] - off if k else -inf
        run, arg, new, bk = inf, 0, [inf] * (lost + 1), [0] * (lost + 1)
        for j in range(lost + 1):
            if cost[j] < run:
                run, arg = cost[j], j
            c = calls[k + j]
            if run < inf and issue_kind(c[0]) == device_kind(d[0]):
                new[j] = run + abs(d[1] - off - max(c[1], ready_prev))
                bk[j] = arg
        cost = new
        back.append(bk)
    j = min(range(lost + 1), key=cost.__getitem__)
    if cost[j] == inf:
        return None
    idx = []
    for k in range(len(dev) - 1, -1, -1):
        idx.append(k + j)
        j = back[k][j]
    return idx[::-1]


def pair(trace, lo, hi, starts):
    """Per frame (cut at the frames' starts `starts`, host clock): (offset,
    [(issue start, (name, start, end))]) of every device activity in
    [lo, hi] with the call that issued it, paired by order on the one
    stream with the kinds matching. A profile can lose device records (a
    few of 78,000 when several profiles share a process, and those that
    end past the window): the calls left without one are placed by
    _place_lost. The offset, the least delay from a call in the frame to
    its activity's start, takes the frame's device times to the host's
    clock. None where there are more activities than calls, more than
    0.1% of the records are lost (one in a window of fewer than 2,000), or
    no order matches the kinds."""
    dev = sorted((d for d in trace.device if d[1] >= lo and d[2] <= hi), key=lambda d: d[1])
    calls = sorted((h for h in trace.host if lo <= h[1] <= hi and issue_kind(h[0])),
                   key=lambda h: h[1])
    lost = len(calls) - len(dev)
    off = _offset(calls, dev)
    if lost < 0 or lost > max(1, len(calls) // 1000) or off is None:
        return None
    idx = list(range(len(dev))) if lost == 0 else _place_lost(calls, dev, off, lost)
    if idx is None or any(issue_kind(calls[i][0]) != device_kind(d[0])
                          for i, d in zip(idx, dev)):
        return None
    frames = [[] for _ in starts]
    for i, d in zip(idx, dev):
        frames[max(bisect.bisect_right(starts, calls[i][1]) - 1, 0)].append((calls[i][1], d))
    return [(min((d[1] - t for t, d in f), default=0.0), f) for f in frames]


def attribute(trace, host_spans, records, counters, lo, hi, n):
    """Layers of the frames profiled in [lo, hi], or None (module doc)."""
    calls = sorted(h[1] for h in trace.host if issue_kind(h[0]))
    frames = align(records, host_spans, trace.spans.get(HARNESS, ()), calls)
    if frames is None or len(frames) != n:
        return None
    requests = {recs[0].request for _, recs in frames}
    layers = Layers({k: 0 for k in LAYERS}, {k: 0.0 for k in LAYERS},
                    {k: 0.0 for k in LAYERS}, counters(requests), 0, n)
    if not trace.device:
        return layers
    marks = sorted(trace.spans.get("frame", ()))
    paired = pair(trace, lo, hi, [s for s, _ in marks])
    if paired is None or len(paired) != len(marks):
        return None
    tl = timeline(frames)
    outside = 0
    dev = [(s, e) for _, s, e in trace.device]
    for (off, pairs), (f_lo, f_hi) in zip(paired, marks):
        for t, (name, s, e) in pairs:
            if device_kind(name) != "launch":
                continue
            who = owner(tl, t)
            if who is None or layer(who) not in layers.launches:
                outside += 1
                continue
            layers.launches[layer(who)] += 1
            layers.device_s[layer(who)] += e - s
        for s, e in stats.gaps(dev, f_lo + off, f_hi + off):
            who = owner(tl, s - off)
            if who is not None and layer(who) in layers.idle_s:
                layers.idle_s[layer(who)] += e - s
    return layers._replace(outside=outside)


def of(r):
    """The Readings' layers, computed once; None (module doc)."""
    if not hasattr(r, "_port_layers"):
        port = port_records()
        r._port_layers = None if port is None else attribute(
            r.trace, r.spans.times, port[0], port[1], r.lo, r.hi, r.n)
    return r._port_layers


def per_frame(r, family, name, scale=1.0):
    """One layer's figure of a device family ("launches", "device_s",
    "idle_s") a frame, or None without layers or without a device trace."""
    lay = of(r)
    if lay is None or not r.trace.device:
        return None
    return scale * getattr(lay, family)[name] / lay.frames
