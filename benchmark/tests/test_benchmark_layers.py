"""pbench/layers.py on a synthetic trace and synthetic port records: the
innermost span takes a kernel, the `render` span anchors the port's
clock, the layers partition the frame's launches and device time, an
idle gap goes to the span open at its start (the device's clock offset
taken out), a lost device record leaves its call unpaired, and a device
activity with no issuing call or a port span outside its harness span
gives None. A CPU traced run reads the lane share and no device
family."""
from types import SimpleNamespace

import pytest

from conftest import small
from pbench import layers, manifest
from pbench.runner import Run
from pbench.trace import Trace

OFF = 100.0          # the trace's clock runs this far ahead of the host's
EPS = 2e-5           # the mark is entered and left this long inside its host span
SKEW = 3e-4          # the device's clock runs this far behind the trace's


def rec(name, seq, parent, request, s, e):
    return SimpleNamespace(name=name, seq=seq, parent=parent, request=request,
                           start_ns=round(s * 1e9), end_ns=round(e * 1e9))


def frame_records(t0, base):
    """One frame's port spans, host clock, starting at t0 (seconds)."""
    r = base
    return [rec("driver.render", r, None, r, t0 + 0.001, t0 + 0.999),
            rec("driver.li", r + 1, r, r, t0 + 0.05, t0 + 0.9),
            rec("sampler.sample_1d", r + 2, r + 1, r, t0 + 0.1, t0 + 0.25),
            rec("tracer.intersect", r + 3, r + 1, r, t0 + 0.3, t0 + 0.6),
            rec("sampler.sample_2d", r + 4, r + 3, r, t0 + 0.35, t0 + 0.36)]


def frame_trace(t0, off=OFF, slow_entry=0.0):
    """One frame's harness spans (host, mark, frame mark), issuing calls
    and device activities, the calls at the named host times; the host
    clock read `slow_entry` before the mark was entered."""
    host = (t0 - slow_entry, t0 + 1.0)
    mark = (t0 + off + EPS, t0 + 1.0 + off - EPS)
    frame = (t0 + off - 0.1, t0 + off + 1.2)
    at = lambda t: t0 + off + t                                   # noqa: E731
    calls = [("cudaLaunchKernel", at(0.06), at(0.061)),          # driver.li's own
             ("cudaLaunchKernel", at(0.15), at(0.151)),          # sampler.sample_1d
             ("cudaLaunchKernel", at(0.355), at(0.356)),         # sample_2d in intersect
             ("cudaLaunchKernel", at(0.4), at(0.401)),           # tracer.intersect
             ("cudaMemcpyAsync", at(0.7), at(0.72))]             # driver.li's own
    dev = [("k_driver", at(0.06), at(0.08)),         # starts at its call: no queue
           ("k_sampler", at(0.16), at(0.2)),
           ("k_sampler2", at(0.357), at(0.37)),
           ("k_tracer", at(0.41), at(0.5)),
           ("Memcpy DtoH (Device -> Pageable)", at(0.71), at(0.72))]
    dev = [(n, s + SKEW, e + SKEW) for n, s, e in dev]
    return host, mark, frame, calls, dev


def build(frames=((10.0, OFF), (20.0, OFF + 3e-6)), drop_call=False, late_root=False,
          lose=None, slow_entry=0.0):
    host_spans, marks, fmarks, calls, dev, records = [], [], [], [], [], []
    for k, (t0, off) in enumerate(frames):
        h, m, f, c, d = frame_trace(t0, off, slow_entry)
        host_spans.append(h)
        marks.append(m)
        fmarks.append(f)
        calls += c
        dev += [x for x in d if k or x[0] != lose]         # lost in the first frame
        records += frame_records(t0, 10 * k)
    host_spans.append((5.0, 6.0))          # an untraced frame: no mark, no port spans
    records.append(rec("driver.render", 99, None, 99, 7.0, 8.0))   # an earlier run's
    if drop_call:
        calls.pop(2)
    if late_root:
        records[0].end_ns = round((frames[0][0] + 1.01) * 1e9)
    host_ops = calls + [("aten::mul", c[1] - 1e-6, c[2]) for c in calls]
    tr = Trace(dev, host_ops, {"render": marks, "frame": fmarks})
    lo, hi = min(s for s, _ in fmarks), max(e for _, e in fmarks)
    counts = {0: {"tracer.lanes": 2048, "tracer.live_lanes": 1500},
              10: {"tracer.lanes": 2048, "tracer.live_lanes": 1000}}

    def counters(requests):
        out = {}
        for q in requests:
            for k, v in counts[q].items():
                out[k] = out.get(k, 0) + v
        return out

    host_frames = [(t0 - 0.1, t0 + 1.2) for t0, _ in frames]
    return tr, {"render": host_spans, "frame": host_frames}, records, counters, lo, hi


def test_innermost_span_takes_the_kernel():
    lay = layers.attribute(*build(), n=2)
    assert lay.launches == {"sampler": 4, "shading": 0, "lights": 0, "compaction": 0,
                            "tracer": 2, "driver": 2}
    assert lay.device_s["sampler"] == pytest.approx(2 * (0.04 + 0.013))
    assert lay.device_s["driver"] == pytest.approx(2 * 0.02)
    assert lay.device_s["tracer"] == pytest.approx(2 * 0.09)
    assert lay.outside == 0
    assert lay.counters == {"tracer.lanes": 4096, "tracer.live_lanes": 2500}


def test_the_render_span_anchors_the_port_clock():
    tr, host, records, counters, lo, hi = build()
    frames = layers.align(records, host, tr.spans["render"])
    assert [off for off, _ in frames] == pytest.approx([OFF, OFF + 3e-6], abs=1e-9)
    assert [len(recs) for _, recs in frames] == [5, 5]
    # marks 200 ms later move the port's spans with them: the tracer's
    # launches fall in sample_1d, the first two before driver.render
    tr2 = tr._replace(spans={"render": [(s + 0.2, e + 0.2) for s, e in tr.spans["render"]],
                             "frame": tr.spans["frame"]})
    moved = layers.attribute(tr2, host, records, counters, lo, hi, 2)
    assert moved.launches["sampler"] == 4 and moved.launches["tracer"] == 0
    assert moved.outside == 4


def test_a_slow_mark_entry_keeps_every_launch_inside_the_render_span():
    """The host clock read 150 ms before the mark: the mark's range alone
    centres the port's spans 75 ms late, past the first launch; the calls
    inside the mark hold the offset where driver.render holds them."""
    tr, host, records, counters, lo, hi = build(slow_entry=0.15)
    lay = layers.attribute(tr, host, records, counters, lo, hi, 2)
    assert lay.outside == 0 and sum(lay.launches.values()) == 8
    frames = layers.align(records, host, tr.spans["render"])
    tl = layers.timeline(frames)
    assert layers.owner(tl, 10.0 + OFF + 0.06) is None        # the mark's range alone


def test_the_layers_partition_the_frames_launches_and_device_time():
    tr, host, records, counters, lo, hi = build()
    lay = layers.attribute(tr, host, records, counters, lo, hi, 2)
    kernels = [k for k in tr.kernels() if k[1] >= lo and k[2] <= hi]
    assert sum(lay.launches.values()) == len(kernels) == 8
    assert sum(lay.device_s.values()) == pytest.approx(sum(e - s for _, s, e in kernels))


def test_an_idle_gap_goes_to_the_span_open_at_its_start():
    lay = layers.attribute(*build(), n=2)
    # per frame: 0.08-0.16 and 0.72-1.2 begin in driver.li, 0.2-0.357 in
    # sample_1d, 0.37-0.41 in tracer.intersect, 0.5-0.71 in it too; the
    # gap from the frame mark's start to the first kernel is the harness's
    assert lay.idle_s["driver"] == pytest.approx(2 * (0.08 + 0.48))
    assert lay.idle_s["sampler"] == pytest.approx(2 * 0.157)
    assert lay.idle_s["tracer"] == pytest.approx(2 * (0.04 + 0.21))
    assert lay.idle_s["shading"] == 0.0


def test_a_lost_device_record_leaves_its_call_unpaired():
    lay = layers.attribute(*build(lose="k_sampler2"), n=2)
    assert lay.launches == {"sampler": 3, "shading": 0, "lights": 0, "compaction": 0,
                            "tracer": 2, "driver": 2}
    assert lay.device_s["tracer"] == pytest.approx(2 * 0.09)
    tr, host, records, counters, lo, hi = build(lose="k_sampler2")
    starts = [s for s, _ in tr.spans["frame"]]
    (off, pairs), _ = layers.pair(tr, lo, hi, starts)
    assert off == pytest.approx(SKEW)
    assert [d[0] for _, d in pairs][2] == "k_tracer" and pairs[2][0] == pytest.approx(
        starts[0] + 0.1 + 0.4)


def test_an_activity_without_its_call_gives_none():
    assert layers.attribute(*build(drop_call=True), n=2) is None


def test_a_port_span_outside_its_harness_span_gives_none():
    assert layers.attribute(*build(late_root=True), n=2) is None


def test_frames_must_match_the_marks():
    tr, host, records, counters, lo, hi = build()
    assert layers.attribute(tr, host, records, counters, lo, hi, 3) is None
    assert layers.attribute(tr, host, [], counters, lo, hi, 2) is None


def test_cpu_traced_run_reads_the_lane_share_and_no_device_family(cpu_threads):
    cell = "cornell_specular.path_64spp"
    r = Run(cell, 3_000_000_019, 0.3, True, "cpu", overrides=small(cell))
    r.execute()
    assert r.error is None, r.error
    got = r.result()["metrics"]
    assert 0.0 < got["tracer_live_lane_share"]["value"] < 100.0
    new = [m["name"] for m in manifest.load()["per_layer"]
           if m["source"] == "program_span"]
    assert len(new) == 18 and not set(new) & set(got)
