"""Milliseconds a profiled frame in which the device idles, in the gaps
that began inside the compaction's span (compaction.compact: the
argsort, index_put and row gather of path.li's compact_from block). The
innermost port span open when the gap began decides (pbench/layers.py)."""
from pbench import layers


def read(r):
    return layers.per_frame(r, "idle_s", "compaction", 1e3)
