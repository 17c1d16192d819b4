"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the sampler's spans (sampler.sample_1d, sample_2d:
core/samplers.py, every caller, the compaction key's included). The
innermost port span open when the gap began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "idle_s", "sampler", 1e3)
