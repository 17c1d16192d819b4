"""The port's tracer (pbrt_tpu_torch/trace.py) on a path frame of the
specular Cornell box, 64×64, 1 spp, depth 5, compaction from bounce 1,
on the CPU:

- off, a frame leaves no record and no count;
- on, the image is bit-equal to the image with tracing off;
- the span tree: one `driver.render` holding one `driver.li` holding
  `max_depth` `driver.bounce` spans, each bounce holding exactly one
  `tracer.intersect`, every span carrying the render's request;
- `tracer.lanes` and `tracer.live_lanes` equal a recount from the inputs
  of each `cluster.prepare`;
- tracing on issues the same aten calls as tracing off;
- `recording()` and the profiler's flag each turn recording on, and
  nothing else does;
- a volumetric frame of config 4's fog box, 16×16, 2 spp, depth 5: on,
  it records the media layer's spans beside the lights', shading's and
  the driver's, its counters hold 0 < `media.events` <= `media.lanes`
  <= the lanes handed to `medium_sample`, and the image is bit-equal to
  the image with tracing off."""
from collections import Counter

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pbrt_tpu_torch import scenes, trace
from pbrt_tpu_torch.core import samplers as smp
from pbrt_tpu_torch.geom import cluster as clmod
from pbrt_tpu_torch.integrate import driver, path, volpath
from pbrt_tpu_torch.shade import media

RES, SPP, DEPTH, TILE = 64, 1, 5, 256


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    """render() of one path frame, with its scene built once."""
    scene = scenes.cornell_spheres(True, "area", "cpu", tile=TILE)
    cam = scenes.cornell_camera((RES, RES), "cpu")
    cfg = driver.RenderConfig(width=RES, height=RES, spp=SPP, max_depth=DEPTH,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=SPP, seed=11))
    li = path.make_li(cfg, camera=cam, compact_from=1, return_stats=True)
    return lambda: driver.render(scene, cam, cfg, li)


@pytest.fixture(scope="module")
def plain_and_recorded(frame):
    trace.clear()
    plain, _ = frame()
    left = (trace.records(), trace.counters())
    with trace.recording() as rec:
        img, _ = frame()
    return plain, left, img, rec


def test_off_a_frame_leaves_no_record(plain_and_recorded):
    _, (records, counts), _, _ = plain_and_recorded
    assert records == [] and counts == {}


def test_on_the_image_is_bit_equal(plain_and_recorded):
    plain, _, img, _ = plain_and_recorded
    assert torch.equal(plain, img)


def test_the_span_tree(plain_and_recorded):
    rec = plain_and_recorded[3]
    recs = rec.records
    kids = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    (root,) = kids[None]
    assert root.name == "driver.render"
    assert all(r.request == root.seq and r.end_ns >= r.start_ns for r in recs)
    (li,) = [r for r in kids[root.seq] if r.name == "driver.li"]
    bounces = [r for r in kids[li.seq] if r.name == "driver.bounce"]
    assert len(bounces) == DEPTH
    for b in bounces:
        assert [r.name for r in kids[b.seq]].count("tracer.intersect") == 1
        inner = [r for r in recs if r.name == "tracer.intersect" and _inside(recs, r, b)]
        assert len(inner) == 1
    names = {r.name for r in recs}
    assert {"driver.camera", "driver.film", "compaction.compact", "sampler.sample_1d",
            "sampler.sample_2d", "lights.emission", "lights.nee", "shading.material",
            "shading.bsdf"} <= names
    assert {trace.layer(n) for n in names} == {"driver", "compaction", "sampler", "lights",
                                               "shading", "tracer"}
    rows = {row[0]: row for row in rec.table()}
    assert rows["driver.bounce"][1] == DEPTH
    assert all(0.0 <= own <= tot + 1e-9 for _, _, tot, own in rows.values())


def _inside(recs, r, anc):
    by_seq = {x.seq: x for x in recs}
    while r.parent is not None:
        r = by_seq[r.parent]
        if r.seq == anc.seq:
            return True
    return False


def test_lane_counters_equal_a_recount(frame, monkeypatch):
    calls = []
    prepare0 = clmod.prepare

    def prepare(cs, o, d, t_min, t_max, tile, flag=None):
        calls.append((cs, o.clone(), d.clone(), t_min.clone(), t_max.clone(), tile))
        return prepare0(cs, o, d, t_min, t_max, tile, flag)

    monkeypatch.setattr(clmod, "prepare", prepare)
    with trace.recording() as rec:
        frame()
    lanes = sum(-(-o.shape[0] // tile) * tile for _, o, _, _, _, tile in calls)
    live = sum(int((clmod.world_exit_cap(cs, o, d, t0, t1) > t0).sum())
               for cs, o, d, t0, t1, _ in calls)
    assert len(calls) == DEPTH + 1
    assert rec.counters() == {"tracer.lanes": lanes, "tracer.live_lanes": live}
    assert 0 < live < lanes


class _AtenCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_tracing_on_issues_the_same_ops(frame):
    with _AtenCalls() as off:
        frame()
    with trace.recording(), _AtenCalls() as on:
        frame()
    assert sum(off.calls.values()) > 1000
    assert on.calls == off.calls


def test_what_turns_recording_on():
    trace.clear()
    assert not trace.on()
    with torch.autograd.profiler.record_function("not a port span"):
        assert not trace.on()
    with trace.recording() as rec:
        assert trace.on()
        with trace.span("driver.render"):
            trace.count("tracer.lanes", 3)
            trace.count("tracer.lanes", torch.tensor(4))
    assert not trace.on()
    assert [r.name for r in rec.records] == ["driver.render"]
    assert rec.counters() == {"tracer.lanes": 7}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.on()
        with trace.span("sampler.sample_1d"):
            pass
    assert not trace.on()
    assert trace.span("x") is trace.span("y")          # the shared no-op
    trace.count("tracer.lanes", 5)
    assert [r.name for r in trace.records()] == ["driver.render", "sampler.sample_1d"]
    assert trace.counters() == {"tracer.lanes": 7}
    trace.clear()
    assert trace.records() == [] and trace.counters() == {}


@pytest.fixture(scope="module")
def fog_frame():
    """render() of one volpath frame of the fog box, scene built once."""
    scene = scenes.fog_scene(device="cpu", tile=TILE)
    cam = scenes.volumetric_camera((16, 16), "cpu")
    cfg = driver.RenderConfig(width=16, height=16, spp=2, max_depth=DEPTH,
                              sampler=smp.SamplerConfig(kind="zerotwo", spp=2, seed=13))
    li = volpath.make_li(cfg, return_stats=True)
    return lambda: driver.render(scene, cam, cfg, li)[0]


def test_a_volpath_frame_records_the_media_layer(fog_frame, monkeypatch):
    plain = fog_frame()
    lanes = []
    sample0 = media.medium_sample

    def medium_sample(*args):
        out = sample0(*args)
        lanes.append(out[0].numel())
        return out

    monkeypatch.setattr(media, "medium_sample", medium_sample)
    with trace.recording() as rec:
        img = fog_frame()
    assert torch.equal(plain, img)
    names = {r.name for r in rec.records}
    assert {"media.sample", "media.tr", "media.phase", "lights.nee", "lights.emission",
            "shading.material", "shading.bsdf", "driver.bounce", "driver.li"} <= names
    rows = {row[0]: row[1] for row in rec.table()}
    assert rows["driver.bounce"] == rows["media.sample"] == DEPTH
    assert rows["media.tr"] == 2 * DEPTH + 1
    counts = rec.counters()
    assert 0 < counts["media.events"] <= counts["media.lanes"] <= sum(lanes)
    assert len(lanes) == DEPTH and counts["media.lanes"] > lanes[0]
