"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the shading spans (shading.material: the shading
frame, the footprint and matmod.resolve; shading.bsdf: matmod.sample,
throughput, Russian roulette, the next ray). The innermost port span
open when the gap began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "idle_s", "shading", 1e3)
