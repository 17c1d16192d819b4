"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the media layer's spans (media.sample, media.tr,
media.phase). The innermost port span open when the gap began decides
(pbench/media_layers.py)."""
from pbench import media_layers


def read(r):
    return media_layers.per_frame(r, "idle_s", 1e3)
