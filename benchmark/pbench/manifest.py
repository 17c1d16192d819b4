"""BENCHMARK.json and the files it names: cells, configurations, traffic
mixes and per-layer metric readers, found by name."""
from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest, name):
    return _named(manifest["workloads"], name, "workload")


def config(manifest, name, root=ROOT):
    """The configuration's entry and the data of its file."""
    entry = _named(manifest["configs"], name, "config")
    with open(os.path.join(root, entry["file"])) as f:
        return entry, json.load(f)


def traffic(name):
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def metrics(manifest, cell_name, kind):
    """The cell's end-to-end ("end_to_end") or per-layer ("per_layer") metrics."""
    return [m for m in manifest[kind] if applies(m, cell_name)]


def reader(name):
    """The per-layer metric's reader module, metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(manifest):
    """What in the manifest breaks the naming rules or names a missing file."""
    out = []
    names = [("config", c["name"]) for c in manifest["configs"]]
    names += [("workload", w["name"]) for w in manifest["workloads"]]
    names += [("workload config", w["config"]) for w in manifest["workloads"]]
    names += [("traffic", w["traffic"]) for w in manifest["workloads"]]
    names += [("metric", m["name"]) for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [("reduced key", k) for c in manifest["configs"] for k in c["reduced"]]
    out += [f"{what} {n!r} is not a name" for what, n in names if not NAME_RE.match(n)]
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher") or m["source"] not in SOURCES:
            out.append(f"better or source of {m['name']}")
    cells = {w["name"] for w in manifest["workloads"]}
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']!r}, no end-to-end metric")
        if not os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{m['name']}.py")):
            out.append(f"no reader metrics/{m['name']}.py")
        for c in m.get("workloads", ()):
            moved = _named(manifest["end_to_end"], m["moves"], "metric")
            if c not in cells or not applies(moved, c):
                out.append(f"{m['name']} lists {c}, which does not report {m['moves']}")
    for w in manifest["workloads"]:
        if not os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json")):
            out.append(f"no traffic file for {w['traffic']}")
        _named(manifest["configs"], w["config"], "config")
    for c in manifest["configs"]:
        if not os.path.exists(os.path.join(ROOT, c["file"])):
            out.append(f"no file {c['file']}")
    return out
