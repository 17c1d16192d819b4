"""Kernels a profiled frame launched inside the tracer's span
(tracer.intersect: geom/scene.py intersect, occluded,
intersect_occluded: the cluster tracer's sort, pad and unsort, its CUDA
kernels, the quadric pass). The innermost port span open when the
kernel's launch call began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "launches", "tracer")
