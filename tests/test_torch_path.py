"""The PyTorch port's path tracer vs the JAX package on the bench scene,
the scene bridge, and the port's import boundary.

The render comparison uses the pixel check of tests/test_oracle.py: at
least 0.995 of pixels within 2e-3 relative and a mean difference under
1e-3. Both packages draw the same sample streams; the JAX package traces
with its lock-step tracer on the CPU (Möller–Trumbore finalize), the port
with the plain versions of its kernels (Plücker t and barycentrics)."""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from pbrt_tpu.integrate import driver as jdriver, path as jpath
from pbrt_tpu.core import samplers as jsmp
from scenes.bunny import mesh_scene, mesh_camera
from tests.test_oracle import _check
from tests.test_torch_bdpt import reference_jit
from tests.test_torch_core import _camera_dict
from tests.test_torch_shade import scene_tree

import pbrt_tpu_torch
from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.integrate import driver as tdriver, path as tpath
from pbrt_tpu_torch.scenes import bench_camera, bench_scene

TILE = int(os.environ.get("PBRT_TPU_TILE", 256))
RES, SUBDIV, DEPTH = 32, 2, 5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_render(scene, cam, spp):
    cfg = tdriver.RenderConfig(width=RES, height=RES, spp=spp, max_depth=DEPTH,
                               sampler=tsmp.SamplerConfig(kind="zerotwo", spp=spp))
    return tdriver.render(scene, cam, cfg, tpath.make_li(cfg, camera=cam,
                                                         compact_from=1)).numpy()


@pytest.fixture(scope="module")
def jax_scene():
    return mesh_scene(subdivisions=SUBDIV, use_bvh=True), mesh_camera((RES, RES))


def test_render_matches_jax(jax_scene):
    """4 spp: the compacted bounces run live > width, so the random-subset
    roulette with live/kept compensation is exercised too."""
    spp = 4
    assert tpath._compact_width(RES * RES * spp, 1, 1) < RES * RES * spp
    js, jc = jax_scene
    jcfg = jdriver.RenderConfig(width=RES, height=RES, spp=spp, max_depth=DEPTH,
                                sampler=jsmp.SamplerConfig(kind="zerotwo", spp=spp))
    with reference_jit():
        img_j = np.asarray(jdriver.render(js, jc, jcfg, jpath.make_li(jcfg, camera=jc,
                                                                      compact_from=1)))
    img_t = _port_render(bench_scene(SUBDIV, "cpu", tile=TILE),
                         bench_camera((RES, RES), "cpu"), spp)
    assert np.isfinite(img_t).all()
    _check(img_t, img_j)


def test_bridge_and_native_scene_render_the_same(jax_scene):
    js, jc = jax_scene
    via_bridge = bridge.scene_from_numpy(scene_tree(js), "cpu", tile=TILE)
    native = bench_scene(SUBDIV, "cpu", tile=TILE)
    for a, b in ((via_bridge.tri.shade_rec, native.tri.shade_rec),
                 (via_bridge.clusters.packed, native.clusters.packed),
                 (via_bridge.clusters.bounds, native.clusters.bounds),
                 (via_bridge.materials.kd, native.materials.kd),
                 (via_bridge.lights.em_tri_p, native.lights.em_tri_p),
                 (via_bridge.textures.atlas, native.textures.atlas)):
        assert torch.equal(a, b)
    img_b = _port_render(via_bridge, bridge.camera_from_numpy(_camera_dict(jc), "cpu"), 1)
    img_n = _port_render(native, bench_camera((RES, RES), "cpu"), 1)
    _check(img_n, img_b)


def test_cluster_tracer_and_brute_force_render_alike():
    cam = bench_camera((RES, RES), "cpu")
    scene = bench_scene(1, "cpu", tile=TILE)
    img_c = _port_render(scene, cam, 1)
    img_b = _port_render(dataclasses.replace(scene, clusters=None), cam, 1)
    _check(img_c, img_b)


def test_compaction_schedule_matches_jax():
    for n0 in (1024, 4096, 262144, 524288):
        for b in range(1, 6):
            for cf in (1, 2):
                if b >= cf:
                    assert tpath._compact_width(n0, b, cf) == jpath._compact_width(n0, b, cf)


def _packed_case(device):
    r = np.random.RandomState(5)
    n = 999
    f = r.randn(n, 3).astype(np.float32)
    f[:4, 0] = [np.nan, np.inf, -np.inf, 1e-42]          # NaN, infinities, a denormal
    ints = r.randint(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    ints[:3] = [0, -1, 262143]
    arrays = [torch.as_tensor(f, device=device), torch.as_tensor(ints, device=device),
              torch.as_tensor(r.rand(n) < 0.5, device=device),
              torch.as_tensor(r.rand(n).astype(np.float32), device=device)]
    order = torch.as_tensor(r.permutation(n)[:700], device=device)
    return arrays, order


def test_gather_packed_is_an_exact_permutation():
    arrays, order = _packed_case("cpu")
    for got, a in zip(tpath._gather_packed(order, arrays), arrays):
        assert got.dtype == a.dtype and got.shape == a[order].shape
        if a.dtype == torch.float32:
            assert torch.equal(got.view(torch.int32), a[order].view(torch.int32))
        else:
            assert torch.equal(got, a[order])


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert pbrt_tpu_torch.resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            bench_scene(1)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args[:1] if isinstance(a, ast.Constant))


def test_port_imports_no_jax_nor_the_jax_package():
    files = [os.path.join(ROOT, f) for f in ("chip_smoke.py", "chip_profile.py",
                                             "chip_kernel_ab.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "pbrt_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    banned = ("jax", "jaxlib", "pbrt_tpu", "scenes", "optax", "flax")
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in banned, f"{f} imports {mod}"
