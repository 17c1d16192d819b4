"""Spans and counters of the port's own work, kept in memory on the host
clock.

    with trace.span("shading.bsdf"):
        ...
    trace.count("tracer.lanes", n)        # a host int, or a device scalar
    with trace.recording() as rec:
        img = driver.render(scene, camera, cfg, li)
    torch.cuda.synchronize()
    rec.table()                           # [(name, count, host ms, host self ms)]
    rec.counters()                        # {name: int}

A span's layer is its name up to the first dot (`layer`). Each record
holds its name, its start and end from time.perf_counter_ns(), its
parent and its request: the outermost span open on the thread when it
began, so every span of one frame carries that frame's `driver.render`.

Recording is on while a torch.profiler records (the profiler's own
flag) and inside `recording()`; nothing else turns it on. Off, `span`
returns one shared no-op object after one flag test and `count` returns
at once. On or off, the tracer launches nothing on the device and never
waits for it: a device scalar handed to `count` is kept as a reference
and read only when the counters are, after the caller's synchronize.

The spans are not torch.profiler.record_function ranges: the profiler
mirrors a range that launches device work onto the device's timeline,
where a reader of the trace would take it for a kernel. A reader of a
profile places these records on the profiler's clock itself."""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

_depth = 0                  # recording() blocks open
_records = []               # every Record, in order of start
_counts = []                # (name, value, request) of every count()
_seq = itertools.count()
_local = threading.local()  # .stack: the thread's open Records


def layer(name):
    return name.split(".", 1)[0]


def on():
    """Whether spans and counts are recorded now."""
    return bool(_depth or _profiler._is_profiler_enabled)


class Record:
    """One span: `seq` its number, `parent` and `request` the numbers of
    the span it opened in and of the outermost span open then (its own
    where it is the outermost); times in perf_counter_ns."""
    __slots__ = ("name", "seq", "parent", "request", "start_ns", "end_ns")

    def __init__(self, name, seq, parent, request, start_ns):
        self.name, self.seq, self.parent, self.request = name, seq, parent, request
        self.start_ns, self.end_ns = start_ns, None


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Span:
    __slots__ = ("name", "rec", "stack")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        st = self.stack = _stack()
        seq = next(_seq)
        top = st[-1] if st else None
        self.rec = Record(self.name, seq, None if top is None else top.seq,
                          seq if top is None else top.request, time.perf_counter_ns())
        _records.append(self.rec)
        st.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.perf_counter_ns()
        self.stack.pop()
        return False


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name):
    """A context manager that records the span `name` while recording is on."""
    if _depth or _profiler._is_profiler_enabled:
        return _Span(name)
    return _OFF


def spanned(name):
    """Decorator: each call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not (_depth or _profiler._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name, value):
    """Add `value` (a host int, or a device scalar already computed) to the
    counter `name`, under the request of the span open on this thread."""
    if not (_depth or _profiler._is_profiler_enabled):
        return
    st = _stack()
    _counts.append((name, value, st[-1].request if st else None))


def records():
    """Every span recorded since the last clear(), in order of start."""
    return list(_records)


def counters(requests=None):
    """{name: sum} of the counts since the last clear(), of the given
    requests only where `requests` is given. Reads device scalars: call it
    after the work that computed them has been synchronized."""
    return _sum(_counts, requests)


def clear():
    """Forget every record and count (not inside a recording() block)."""
    del _records[:]
    del _counts[:]


def _sum(events, requests=None):
    out = {}
    for name, value, req in events:
        if requests is None or req in requests:
            out[name] = out.get(name, 0) + int(value)
    return out


def table(recs):
    """[(name, count, host ms, host self ms)] of the records by name, the
    most self time first; self time is a span's time less its children's."""
    child_ns = {}
    for r in recs:
        if r.parent is not None and r.end_ns is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.end_ns - r.start_ns
    rows = {}
    for r in recs:
        if r.end_ns is None:
            continue
        n, tot, own = rows.get(r.name, (0, 0, 0))
        dur = r.end_ns - r.start_ns
        rows[r.name] = (n + 1, tot + dur, own + dur - child_ns.get(r.seq, 0))
    return sorted(((k, n, tot * 1e-6, own * 1e-6) for k, (n, tot, own) in rows.items()),
                  key=lambda row: -row[3])


class Recording:
    """What was recorded inside one `recording()` block."""

    def __init__(self):
        self._r = (len(_records), None)
        self._c = (len(_counts), None)

    def _close(self):
        self._r = (self._r[0], len(_records))
        self._c = (self._c[0], len(_counts))

    @property
    def records(self):
        return _records[self._r[0]:self._r[1]]

    def counters(self):
        return _sum(_counts[self._c[0]:self._c[1]])

    def table(self):
        return table(self.records)


@contextlib.contextmanager
def recording():
    """Record spans and counts inside the block, with no profiler."""
    global _depth
    rec = Recording()
    _depth += 1
    try:
        yield rec
    finally:
        _depth -= 1
        rec._close()
