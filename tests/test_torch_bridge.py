"""The bridge refuses what the port would drop without a word: a scene
tree that does not state its quadric and instance counts, one that
states quadrics and leaves out their arrays, one with instances, and a
material table that leaves out a texture channel the port does not have.
The Cornell box's tree (two spheres) bridges."""
import numpy as np
import pytest

from scenes.bunny import mesh_scene
from scenes.cornell import cornell_spheres
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.shade import materials as tmat


@pytest.mark.parametrize("drop", [("quad_count",), ("instance_count",),
                                  ("quad_count", "instance_count")])
def test_tree_without_counts_is_refused(drop):
    """Dropping a count is refused for both trees; the Cornell tree also
    without its quadric arrays, and with an instance stated."""
    cornell = scene_tree(cornell_spheres())
    assert cornell["quad_count"] == 2
    mesh = scene_tree(mesh_scene(subdivisions=1, use_bvh=True))
    assert mesh["quad_count"] == 0 and mesh["instance_count"] == 0
    bridge.scene_from_numpy(mesh, "cpu", tile=256)
    assert bridge.scene_from_numpy(cornell, "cpu", tile=256).quad.count == 2
    for tree in (cornell, mesh):
        with pytest.raises(NotImplementedError):
            bridge.scene_from_numpy({k: v for k, v in tree.items() if k not in drop},
                                    "cpu", tile=256)
    with pytest.raises(NotImplementedError):
        bridge.scene_from_numpy(dict(cornell, quad=None), "cpu", tile=256)
    with pytest.raises(NotImplementedError):
        bridge.scene_from_numpy(dict(mesh, instance_count=1), "cpu", tile=256)


@pytest.mark.parametrize("channel", tmat.UNPORTED_CHANNELS)
def test_material_table_without_a_channel_is_refused(channel):
    mats = scene_tree(mesh_scene(subdivisions=1, use_bvh=True))["materials"]
    assert all((np.asarray(mats[ch]) < 0).all() for ch in tmat.UNPORTED_CHANNELS)
    tmat.materials_from_numpy(mats, "cpu")
    with pytest.raises(NotImplementedError):
        tmat.materials_from_numpy({k: v for k, v in mats.items() if k != channel}, "cpu")
    with pytest.raises(NotImplementedError):
        tmat.materials_from_numpy(dict(mats, **{channel: np.zeros_like(mats[channel])}),
                                  "cpu")
