"""Kernels a profiled frame launched inside the shading spans
(shading.material: the shading frame, the footprint and matmod.resolve;
shading.bsdf: matmod.sample, throughput, Russian roulette, the next
ray). The innermost port span open when the kernel's launch call began
decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "launches", "shading")
