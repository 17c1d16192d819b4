"""BENCHMARK.json against the naming rules, and discovery of every file
it names."""
import json
import os

import pytest

from pbench import manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_no_problems():
    assert manifest.problems(MAN) == []


@pytest.mark.parametrize("name,ok", [("frame_ms", True), ("device_idle_share.render", True),
                                     ("cornell_specular.path_64spp", True), ("a b", False),
                                     ("a/b", False), ("a,b", False), (".x", False),
                                     ("x" * 65, False), ("µs", False)])
def test_name_rule(name, ok):
    assert bool(manifest.NAME_RE.match(name)) == ok


@pytest.mark.parametrize("unit,ok", [("ms", True), ("%", True), ("tokens/s", True),
                                     ("GiB", True), ("launches", True), ("per second", False),
                                     ("x" * 17, False), ("µs", False)])
def test_unit_rule(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) == ok


def test_every_unit_keeps_the_rule():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert manifest.UNIT_RE.match(m["unit"]), m


def test_end_to_end_metrics_are_the_chosen_ones():
    assert {m["name"] for m in MAN["end_to_end"]} == {
        "frame_ms", "frame_p90_ms", "step_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = {m["name"] for m in manifest.metrics(MAN, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = manifest.metrics(MAN, cell, "per_layer")
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("cell", CELLS)
def test_discovery_by_name(cell):
    c = manifest.cell(MAN, cell)
    entry, conf = manifest.config(MAN, c["config"])
    assert entry["file"] == f"benchmark/configs/{c['config']}.json"
    assert manifest.traffic(c["traffic"])["kind"] in ("render", "train")
    for m in manifest.metrics(MAN, cell, "per_layer"):
        assert callable(manifest.reader(m["name"]).read)
    assert os.path.exists(os.path.join(manifest.BENCH_DIR, "limits", f"{cell}.json"))


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_config_states_source_assumed_reduced(config):
    entry, conf = manifest.config(MAN, config)
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert isinstance(conf["assumed"], list) and conf["assumed"]


def test_run_seconds_fit_a_full_check_of_24_cells():
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_manifest_is_small():
    path = os.path.join(manifest.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    assert set(json.load(open(path))) == {"command", "paths", "run_seconds", "configs",
                                          "workloads", "end_to_end", "per_layer"}
