"""The port's checkpoint and resume against tests/test_io_checkpoint.py,
and the .npz layout across the two packages.

- A render stopped after half its samples, saved, loaded and finished
  equals the straight render bit for bit (tests/test_io_checkpoint.py:24
  allows rtol 1e-5; the port's film sums are the same additions in the
  same order either way).
- The pytree round trip of tests/test_io_checkpoint.py:40.
- A .npz written by pbrt_tpu.diff.checkpoint.save_pytree loads in the
  port, and one written by the port loads in pbrt_tpu, leaf for leaf, on
  trees whose keys are out of order and which hold tuples, lists and
  None; a RenderCheckpoint crosses both ways too.
- RenderCheckpoint and load_pytree put what they make on the card unless
  the caller asks for the CPU."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from pbrt_tpu.diff import checkpoint as jckpt
from tests.test_torch_media import one_torch_thread  # noqa: F401

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.core import samplers as tsmp
from pbrt_tpu_torch.diff import checkpoint as tckpt
from pbrt_tpu_torch.integrate import direct as tdirect, driver as tdriver


def test_render_resume_is_exact(tmp_path):
    scene = tscenes.cornell_spheres(False, "area", "cpu", tile=256)
    cam = tscenes.cornell_camera((16, 16), "cpu")
    cfg = tdriver.RenderConfig(width=16, height=16, spp=4, samples_per_batch=2,
                               sampler=tsmp.SamplerConfig(kind="zerotwo", spp=4))
    li = tdirect.make_li(cfg)
    straight = tdriver.render(scene, cam, cfg, li).numpy()
    path = str(tmp_path / "ck.npz")
    half = tckpt.render_resumable(scene, cam, cfg._replace(spp=2), li, checkpoint_path=path)
    assert tckpt.RenderCheckpoint.load(path, "cpu").next_sample == 2
    resumed = tckpt.render_resumable(scene, cam, cfg, li, checkpoint_path=path).numpy()
    np.testing.assert_array_equal(resumed, straight)
    assert not np.array_equal(half.numpy(), straight)


def test_pytree_roundtrip(tmp_path):
    tree = {"a": torch.arange(5.0), "b": (torch.ones((2, 2)), torch.zeros(3))}
    p = str(tmp_path / "t.npz")
    tckpt.save_pytree(p, tree, meta={"step": 7})
    back, meta = tckpt.load_pytree(p, tree)
    assert meta["step"] == 7
    np.testing.assert_allclose(back["a"].numpy(), np.arange(5.0))
    assert isinstance(back["b"], tuple) and back["b"][0].shape == (2, 2)


def test_checkpoints_default_to_the_card(tmp_path):
    """RenderCheckpoint and a load_pytree leaf that replaces no tensor go
    to resolve_device's device: the card unless "cpu" is asked for (and
    with no card, asking for it raises)."""
    p = str(tmp_path / "t.npz")
    tckpt.save_pytree(p, {"a": np.arange(3.0, dtype=np.float32)})
    back, _ = tckpt.load_pytree(p, {"a": np.zeros(3)}, device="cpu")
    assert back["a"].device.type == "cpu"
    assert tckpt.RenderCheckpoint(2, 3, "cpu").acc.device.type == "cpu"
    if torch.cuda.is_available():
        assert tckpt.RenderCheckpoint(2, 3).acc.device.type == "cuda"
        assert tckpt.load_pytree(p, {"a": np.zeros(3)})[0]["a"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.RenderCheckpoint(2, 3)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tckpt.load_pytree(p, {"a": np.zeros(3)})


def _trees(r):
    """The same tree in both packages: dict keys out of order, a tuple, a
    list, None, int and float leaves."""
    a = [r.rand(3, 2).astype(np.float32), r.rand(4).astype(np.float32),
         np.arange(6, dtype=np.int32).reshape(2, 3), r.rand(1).astype(np.float32),
         r.rand(2, 2, 2).astype(np.float32)]

    def build(f):
        return {"zeta": f(a[0]), "alpha": (f(a[1]), None, [f(a[2]), f(a[3])]),
                "mid": {"y": f(a[4]), "x": None}}

    return build(jnp.asarray), build(torch.as_tensor), a


def test_npz_written_by_jax_loads_in_the_port(tmp_path):
    jtree, ttree, _ = _trees(np.random.RandomState(3))
    p = str(tmp_path / "j.npz")
    jckpt.save_pytree(p, jtree, meta={"step": 11, "who": "jax"})
    like = tckpt.tree_map(torch.zeros_like, ttree)
    back, meta = tckpt.load_pytree(p, like)
    assert meta == {"step": 11, "who": "jax"}
    for x, y in zip(tckpt.tree_flatten(back)[0], tckpt.tree_flatten(ttree)[0]):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert back["alpha"][1] is None and back["mid"]["x"] is None


def test_npz_written_by_the_port_loads_in_jax(tmp_path):
    jtree, ttree, _ = _trees(np.random.RandomState(5))
    p = str(tmp_path / "t.npz")
    tckpt.save_pytree(p, ttree, meta={"step": 12})
    back, meta = jckpt.load_pytree(p, jtree)
    assert meta == {"step": 12}
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jtree)):
        assert x.dtype == y.dtype and np.array_equal(np.asarray(x), np.asarray(y))


def test_render_checkpoint_crosses_both_ways(tmp_path):
    r = np.random.RandomState(9)
    acc, wacc = r.rand(4, 5, 3).astype(np.float32), r.rand(4, 5).astype(np.float32)
    jck = jckpt.RenderCheckpoint(4, 5)
    jck.add_batch(jnp.asarray(acc), jnp.asarray(wacc), 3)
    jck.save(str(tmp_path / "j.npz"))
    tck = tckpt.RenderCheckpoint.load(str(tmp_path / "j.npz"), "cpu")
    assert tck.next_sample == 3
    np.testing.assert_array_equal(tck.image().numpy(), np.asarray(jck.image()))
    tck.add_batch(torch.as_tensor(acc), torch.as_tensor(wacc), 2)
    tck.save(str(tmp_path / "t.npz"))
    jback = jckpt.RenderCheckpoint.load(str(tmp_path / "t.npz"))
    assert jback.next_sample == 5
    np.testing.assert_array_equal(np.asarray(jback.acc), tck.acc.numpy())
