"""Device milliseconds a profiled frame in the kernels launched inside the
sampler's spans (sampler.sample_1d, sample_2d: core/samplers.py, every
caller, the compaction key's included). The innermost port span open
when the kernel's launch call began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "device_s", "sampler", 1e3)
