"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the tracer's span (tracer.intersect: geom/scene.py
intersect, occluded, intersect_occluded: the cluster tracer's sort, pad
and unsort, its CUDA kernels, the quadric pass). The innermost port span
open when the gap began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "idle_s", "tracer", 1e3)
