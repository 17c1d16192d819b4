"""Whole runs at CPU sizes: the result line, the refusal without a card,
the import guard, and `correct` coming out false under each planted
fault and for the control."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import small
from pbench import check, faults, guard, manifest
from pbench.runner import Run

MAN = manifest.load()
RENDER_CELLS = [w["name"] for w in MAN["workloads"]
                if manifest.traffic(w["traffic"])["kind"] == "render"]
TRAIN_CELLS = [w["name"] for w in MAN["workloads"]
               if manifest.traffic(w["traffic"])["kind"] == "train"]
SEED = 3_000_000_017          # above 2**31: seeds need more than 32 signed bits


def _run(cell, traced=False, seconds=0.3):
    r = Run(cell, SEED, seconds, traced, "cpu", overrides=small(cell))
    r.execute()
    assert r.error is None, r.error
    return r


@pytest.mark.parametrize("cell", RENDER_CELLS + TRAIN_CELLS)
def test_cpu_run_is_correct(cell, cpu_threads):
    res = _run(cell).result()
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    wanted = {m["name"] for m in manifest.metrics(MAN, cell, "end_to_end")}
    assert set(res["metrics"]) == wanted - {"peak_mem_gib"}      # no card memory on the CPU
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == set(check.limits(cell))
    assert res["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", [RENDER_CELLS[0]] + TRAIN_CELLS)
def test_cpu_traced_run_reads_host_metrics(cell, cpu_threads):
    res = _run(cell, traced=True).result()
    assert res["correct"]
    assert "scene_build_s" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert len(res["breakdown"]["idle_gaps"]) <= 10


@pytest.mark.parametrize("cell,fault", [(c, f) for c in RENDER_CELLS[:1] for f in faults.RENDER]
                         + [(c, f) for c in TRAIN_CELLS for f in faults.TRAIN])
def test_a_planted_fault_is_not_correct(cell, fault, cpu_threads):
    table = faults.RENDER if fault in faults.RENDER and cell in RENDER_CELLS else faults.TRAIN
    with table[fault]():
        r = _run(cell, seconds=0.6)
    assert not r.result()["correct"]


@pytest.mark.parametrize("cell", RENDER_CELLS + TRAIN_CELLS)
def test_the_control_is_not_correct(cell, cpu_threads):
    """The reference in bfloat16 in the port's place fails the limits."""
    import readings
    r = Run(cell, SEED, 0.0, False, "cpu", overrides=small(cell))
    fn = readings.train_readings if cell in TRAIN_CELLS else readings.render_readings
    rows = [row for row in fn(r, [SEED, SEED + 1], True, False) if row["reading"] == "control"]
    lim = check.limits(cell)
    for row in rows:
        assert not check.judge(row, lim)[0], row


def test_cli_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine without one")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", RENDER_CELLS[0],
                        "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                       cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_port_the_run_fails(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", RENDER_CELLS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.parametrize("mods,bad", [(["pbrt_tpu_torch", "pbrt_tpu_torch.geom"], []),
                                      (["pbrt_tpu.core.types"], ["pbrt_tpu"]),
                                      (["jax.numpy", "flax"], ["flax", "jax"]),
                                      (["jaxlib", "jax_like"], ["jaxlib"])])
def test_import_guard_compares_top_level_names_whole(mods, bad):
    assert guard.banned_modules(mods) == bad


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _py_files(sub):
    for dirpath, _, files in os.walk(os.path.join(manifest.BENCH_DIR, sub)):
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


@pytest.mark.parametrize("sub,banned", [("plainref", guard.BANNED | {"pbrt_tpu_torch", "pbench"}),
                                        ("pbench", guard.BANNED), ("metrics", guard.BANNED)])
def test_sources_import_nothing_banned(sub, banned):
    for path in _py_files(sub):
        for name in _imports(path):
            assert name.split(".")[0] not in banned, (path, name)


def test_a_run_loads_no_jax(tmp_path):
    code = ("import sys; sys.path[:0] = ['benchmark', '.']\n"
            "import torch; torch.set_num_threads(2)\n"
            "from conftest import small\n"
            "from pbench.runner import Run\nfrom pbench import guard\n"
            f"r = Run('{RENDER_CELLS[0]}', 5, 0.2, False, 'cpu', overrides=small('{RENDER_CELLS[0]}'))\n"
            "r.execute(); assert r.error is None, r.error\n"
            "print(guard.banned_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(manifest.BENCH_DIR, "tests"))
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                       text=True, timeout=300, env=env)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')) == []


@pytest.mark.cuda
@pytest.mark.parametrize("cell", RENDER_CELLS + TRAIN_CELLS)
def test_the_control_is_not_correct_at_cell_size(cell, card):
    """On the card, at the cell's own size, on three seeds."""
    import readings
    r = Run(cell, SEED, 0.0, False, "cuda")
    fn = readings.train_readings if cell in TRAIN_CELLS else readings.render_readings
    rows = [row for row in fn(r, [SEED + k for k in range(3)], True, False)
            if row["reading"] == "control"]
    assert len(rows) == 3
    for row in rows:
        assert not check.judge(row, check.limits(cell))[0], row
