"""Kernels a profiled frame launched inside the compaction's span
(compaction.compact: the argsort, index_put and row gather of path.li's
compact_from block). The innermost port span open when the kernel's
launch call began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "launches", "compaction")
