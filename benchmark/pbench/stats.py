"""Frozen arithmetic of the end-to-end and device metrics."""
from __future__ import annotations

import math


def per_item_ms(window_s, n):
    """The window's whole time over the items completed in it, in ms."""
    return 1e3 * window_s / n


def percentile(values, q):
    """The nearest-rank q-th percentile (0 < q <= 100) of every value."""
    s = sorted(values)
    return s[max(math.ceil(q / 100.0 * len(s)) - 1, 0)]


def union_seconds(intervals, lo=None, hi=None):
    """Total length of the union of (start, end) intervals, clipped to
    [lo, hi] when given: overlapping intervals count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo, hi):
    """The idle gaps (start, end) within [lo, hi] outside the union."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]

