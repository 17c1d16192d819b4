"""The profiled frames' device time, launches and idle gaps put down to
the port's `media` layer (its spans media.sample, media.tr and
media.phase, pbrt_tpu_torch/shade/media.py), as layers.py puts them
down to its six layers: the port's spans placed on the trace's clock
(`layers.align`), each device activity paired with the call that issued
it (`layers.pair`), a kernel to the innermost port span open when its
launch call began and an idle gap to the innermost one open when it
began (`layers.timeline`, `layers.owner`, `stats.gaps`).

`of(r)` computes this once per Readings and returns None, so that every
metric over it is left out, where layers.py would return None, and where
the port records no `media.lanes` count: a port without the media layer's
spans and counters."""
from __future__ import annotations

from . import layers, stats

LAYER = "media"


def attribute(trace, host_spans, records, counters, lo, hi, n):
    """A layers.Layers of the media layer alone, over the frames profiled
    in [lo, hi], or None."""
    calls = sorted(h[1] for h in trace.host if layers.issue_kind(h[0]))
    frames = layers.align(records, host_spans, trace.spans.get(layers.HARNESS, ()), calls)
    if frames is None or len(frames) != n:
        return None
    requests = {recs[0].request for _, recs in frames}
    lay = layers.Layers({LAYER: 0}, {LAYER: 0.0}, {LAYER: 0.0}, counters(requests), 0, n)
    if not trace.device:
        return lay
    marks = sorted(trace.spans.get("frame", ()))
    paired = layers.pair(trace, lo, hi, [s for s, _ in marks])
    if paired is None or len(paired) != len(marks):
        return None
    tl = layers.timeline(frames)
    outside = 0
    dev = [(s, e) for _, s, e in trace.device]
    for (off, pairs), (f_lo, f_hi) in zip(paired, marks):
        for t, (name, s, e) in pairs:
            if layers.device_kind(name) != "launch":
                continue
            who = layers.owner(tl, t)
            if who is None or layers.layer(who) != LAYER:
                outside += 1
                continue
            lay.launches[LAYER] += 1
            lay.device_s[LAYER] += e - s
        for s, e in stats.gaps(dev, f_lo + off, f_hi + off):
            who = layers.owner(tl, s - off)
            if who is not None and layers.layer(who) == LAYER:
                lay.idle_s[LAYER] += e - s
    return lay._replace(outside=outside)


def of(r):
    """The Readings' media layer, computed once; None (module doc)."""
    if not hasattr(r, "_media_layer"):
        port = layers.port_records()
        lay = None if port is None else attribute(
            r.trace, r.spans.times, port[0], port[1], r.lo, r.hi, r.n)
        r._media_layer = lay if lay is not None and lay.counters.get("media.lanes") else None
    return r._media_layer


def per_frame(r, family, scale=1.0):
    """The media layer's figure of a device family ("launches",
    "device_s", "idle_s") a frame, or None without it or without a
    device trace."""
    lay = of(r)
    if lay is None or not r.trace.device:
        return None
    return scale * getattr(lay, family)[LAYER] / lay.frames
