"""The fog box's cell (traffic kind medium_render) at CPU sizes: the run
is correct, its scene is the port's scenes.fog_scene, the bfloat16
control and each planted fault fail its limits, and the media layer's
four readers read a synthetic trace (pbench/media_layers.py over
test_benchmark_layers.py's frames, two of whose spans renamed into the
media layer) and read nothing from a port without the layer."""
import dataclasses

import pytest
import torch

import readings
import test_benchmark_layers as tl
from pbench import check, faults, layers, manifest, media_layers, medium_render
from pbench.runner import Run

CELL = "fog_box.volpath_4spp"
MAN = manifest.load()
SEED = 3_000_000_029          # above 2**31: seeds need more than 32 signed bits
SMALL = {"traffic": {"width": 16, "height": 16, "spp": 2, "warmup_frames": 1,
                     "traced_frames": 2}}
READERS = ("device_ms_per_frame.media", "launches_per_frame.media", "idle_ms_per_frame.media",
           "medium_event_share")


def _run(traced=False, seconds=0.3):
    r = Run(CELL, SEED, seconds, traced, "cpu", overrides=SMALL)
    r.execute()
    assert r.error is None, r.error
    return r


def test_the_manifest_has_no_problems():
    assert manifest.problems(MAN) == []
    assert manifest.traffic(manifest.cell(MAN, CELL)["traffic"])["kind"] == "medium_render"
    assert {m["name"] for m in manifest.metrics(MAN, CELL, "per_layer")} \
        == {"scene_build_s", *READERS}


def test_cpu_run_is_correct(cpu_threads):
    res = _run().result()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    wanted = {m["name"] for m in manifest.metrics(MAN, CELL, "end_to_end")}
    assert wanted == {"frame_ms", "frame_p90_ms", "peak_mem_gib", "setup_s"}
    assert set(res["metrics"]) == wanted - {"peak_mem_gib"}      # no card memory on the CPU
    assert set(res["compared"]) == set(check.limits(CELL))


def test_cpu_traced_run_reads_the_event_share_and_no_device_family(cpu_threads):
    got = _run(traced=True).result()["metrics"]
    assert got["scene_build_s"]["value"] > 0
    assert 0.0 < got["medium_event_share"]["value"] < 100.0
    assert not set(READERS[:3]) & set(got)


def test_the_scene_is_the_ports_fog_scene():
    from pbrt_tpu_torch import scenes
    r = Run(CELL, SEED, 0.0, False, "cpu", overrides=SMALL)
    built = medium_render.MediumPkg().scene(r.conf, "cpu")
    fog = scenes.fog_scene(device="cpu")
    for part in ("tri", "quad", "materials", "lights", "media"):
        a, b = getattr(built, part), getattr(fog, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if torch.is_tensor(x):
                assert x.dtype == y.dtype and torch.equal(x, y), (part, f.name)
    assert built.world_radius == fog.world_radius


@pytest.mark.parametrize("fault", list(faults.RENDER))
def test_a_planted_fault_is_not_correct(fault, cpu_threads):
    with faults.RENDER[fault]():
        r = _run(seconds=0.6)
    assert not r.result()["correct"]


def test_the_control_is_not_correct(cpu_threads):
    """The reference in bfloat16 in the port's place fails the limits."""
    r = Run(CELL, SEED, 0.0, False, "cpu", overrides=SMALL)
    with medium_render.ported():
        rows = [row for row in readings.render_readings(r, [SEED, SEED + 1], True, False)]
    assert [row["reading"] for row in rows] == ["port", "control"] * 2
    for row in rows:
        assert check.judge(row, check.limits(CELL))[0] == (row["reading"] == "port"), row


def _media_build(counts=True):
    """test_benchmark_layers' two frames with sample_1d as media.sample and
    tracer.intersect as media.tr; their counters the media layer's."""
    tr, host, records, _, lo, hi = tl.build()
    for r in records:
        r.name = {"sampler.sample_1d": "media.sample",
                  "tracer.intersect": "media.tr"}.get(r.name, r.name)
    per = {"media.lanes": 4096, "media.events": 1024} if counts else {}
    return tr, host, records, lambda requests: {k: v * len(requests) for k, v in per.items()}, \
        lo, hi


def test_the_media_layer_takes_its_spans_kernels_and_gaps():
    lay = media_layers.attribute(*_media_build(), n=2)
    assert lay.launches == {"media": 4} and lay.outside == 4
    assert lay.device_s["media"] == pytest.approx(2 * (0.04 + 0.09))
    assert lay.idle_s["media"] == pytest.approx(2 * (0.157 + 0.04 + 0.21))
    assert media_layers.attribute(*tl.build(drop_call=True), n=2) is None


@pytest.mark.parametrize("counts,want", [
    (True, {"device_ms_per_frame.media": 130.0, "launches_per_frame.media": 2.0,
            "idle_ms_per_frame.media": 407.0, "medium_event_share": 25.0}),
    (False, {name: None for name in READERS})])
def test_the_readers_read_a_synthetic_trace(counts, want, monkeypatch):
    tr, host, records, counters, lo, hi = _media_build(counts)
    monkeypatch.setattr(layers, "port_records", lambda: (records, counters))
    r = type("R", (), dict(trace=tr, spans=type("S", (), {"times": host}), lo=lo, hi=hi,
                           n=2))()
    got = {name: manifest.reader(name).read(r) for name in READERS}
    assert got == {k: v if v is None else pytest.approx(v) for k, v in want.items()}
