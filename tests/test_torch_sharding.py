"""The port's pixel sharding on torch.distributed, in two gloo processes
on the CPU (tests/test_sharding.py's contract, as tests/test_multihost_2proc.py
runs two processes):

- the 2-rank render_sharded is bit-equal to the 1-rank one and to
  driver.render, at 15×15 (225 pixels: the pixel axis is padded to 226);
- the 2-rank train step (its gradient all-reduced) gives the loss of the
  1-rank step within rtol 1e-6 and the same params within rtol 1e-5,
  atol 1e-7 (the two ranks' partial sums add in another order);
- both ranks leave through the interpreter's teardown with exit code 0
  (sharding.Mesh holds no ProcessGroup object: one kept past
  destroy_process_group aborted there in about one exit in twenty);
- ensure_initialized is a no-op in a single process, and make_mesh there
  is one rank; a group of the wrong backend is refused."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_media import one_torch_thread  # noqa: F401

from pbrt_tpu_torch.dist import multihost, sharding

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys
sys.path.insert(0, {root!r})
import numpy as np
import torch
torch.set_num_threads(1)
from pbrt_tpu_torch import scenes
from pbrt_tpu_torch.core import samplers as smp
from pbrt_tpu_torch.dist import multihost, sharding
from pbrt_tpu_torch.integrate import driver, path

nproc, pid = multihost.ensure_initialized({coord!r}, 2, {pid}, "cpu")
assert (nproc, pid) == (2, {pid}), (nproc, pid)
mesh = sharding.make_mesh()
assert mesh.size == 2 and mesh.rank == {pid}
scene = scenes.cornell_spheres(False, "area", "cpu", tile=256)

def cfg(res, spp):
    return driver.RenderConfig(width=res, height=res, spp=spp, max_depth=3,
                               sampler=smp.SamplerConfig(kind="zerotwo", spp=spp))

c = cfg(15, 2)
cam = scenes.cornell_camera((15, 15), "cpu")
li = path.make_li(c)
img2 = sharding.render_sharded(scene, cam, c, li, mesh=mesh)
img1 = sharding.render_sharded(scene, cam, c, li, mesh=sharding.make_mesh(1))
assert torch.equal(img1, img2)
assert torch.equal(img1, driver.render(scene, cam, c, li))

c = cfg(16, 1)
cam = scenes.cornell_camera((16, 16), "cpu")
target = torch.zeros((16, 16, 3))
pget = lambda sc: {{"kd": sc.materials.kd}}
import dataclasses
pset = lambda sc, p: dataclasses.replace(
    sc, materials=dataclasses.replace(sc.materials, kd=p["kd"]))
out = {{}}
for tag, m in (("one", sharding.make_mesh(1)), ("two", mesh)):
    step = sharding.make_train_step(c, path.make_li(c), pget, pset, mesh=m)
    sc, loss = step(scene, cam, target, 0.05)
    out[tag + "_loss"] = float(loss)
    out[tag + "_kd"] = sc.materials.kd.numpy()
out["kd0"] = scene.materials.kd.numpy()
try:
    sharding.check_backend(mesh, torch.device("cuda"))
except RuntimeError as e:
    assert "need a nccl process group, not gloo" in str(e), e
else:
    raise SystemExit("the gloo group would take cuda tensors")
if {pid} == 0:
    np.savez({out!r}, **out)
multihost.shutdown()
print("OK", {pid}, flush=True)
"""


def test_two_gloo_processes_match_one(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "out.npz")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PBRT_TPU_")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER.format(
        root=ROOT, coord=f"127.0.0.1:{port}", pid=pid, out=out)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for pid, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"OK {pid}" in text, f"rank {pid}:\n{text[-3000:]}"
    r = np.load(out)
    np.testing.assert_allclose(r["two_loss"], r["one_loss"], rtol=1e-6)
    np.testing.assert_allclose(r["two_kd"], r["one_kd"], rtol=1e-5, atol=1e-7)
    assert np.abs(r["one_kd"] - r["kd0"]).max() > 1e-4     # the step moved kd


def test_single_process_is_one_rank(monkeypatch):
    for k in ("PBRT_TPU_COORDINATOR", "PBRT_TPU_NUM_PROCESSES", "PBRT_TPU_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.ensure_initialized(device="cpu") == (1, 0)
    assert sharding.make_mesh() == sharding.Mesh(False, 1, 0)
    with pytest.raises(ValueError):
        sharding.make_mesh(2)
    with pytest.raises(ValueError):
        multihost.ensure_initialized(num_processes=2, device="cpu")
    assert not torch.distributed.is_initialized()
