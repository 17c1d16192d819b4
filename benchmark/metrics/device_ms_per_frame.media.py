"""Device milliseconds a profiled frame in the kernels launched inside
the media layer's spans (media.sample: the free flight; media.tr: each
transmittance; media.phase: the HG asymmetry, value and sample). The
innermost port span open when the kernel's launch call began decides
(pbench/media_layers.py)."""
from pbench import media_layers


def read(r):
    return media_layers.per_frame(r, "device_s", 1e3)
