"""Kernels a profiled frame launched inside the media layer's spans
(media.sample, media.tr, media.phase). The innermost port span open when
the kernel's launch call began decides (pbench/media_layers.py)."""
from pbench import media_layers


def read(r):
    return media_layers.per_frame(r, "launches")
