"""The bridge refuses what the port would drop without a word: a scene
tree that does not state its quadric and instance counts or its media,
one that states quadrics and leaves out their arrays, one that states
instance sets other than those it carries, and a material table that
leaves out a texture channel or its medium interface columns. The
Cornell box's tree (two spheres) bridges; a fog tree keeps its medium, a
table with interface columns keeps them, and a tree with instance sets
and a BVH keeps both."""
import numpy as np
import pytest

from pbrt_tpu.api import SceneBuilder
from scenes.bunny import mesh_scene
from scenes.cornell import cornell_spheres
from scenes.volumetric import fog_scene, smoke_scene
from tests.test_torch_shade import scene_tree

from pbrt_tpu_torch import bridge
from pbrt_tpu_torch.shade import materials as tmat
from pbrt_tpu_torch.shade import media as tmed


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
    with pytest.raises(NotImplementedError):      # states an instance set, carries none
        bridge.scene_from_numpy(dict(mesh, instance_count=1), "cpu", tile=256)


def test_tree_with_instances_and_a_bvh_bridges():
    """A scene with an instance set and BVHArrays: the bridge carries the
    set's columns and the BVH as they are; a tree that states fewer sets
    than it carries is refused."""
    from pbrt_tpu.geom import bvh as jbvh
    from tests.test_torch_instances import emissive
    b = SceneBuilder()
    emissive(b)
    js = b.build()
    js = js._replace(bvh=jbvh.build_bvh(np.asarray(js.tri.positions), np.asarray(js.tri.indices)))
    tree = scene_tree(js)
    assert tree["instance_count"] == 1 and tree["bvh"] is not None
    ts = bridge.scene_from_numpy(tree, "cpu", tile=256)
    assert ts.instances[0].count == 1 and ts.instances[0].clusters is None
    assert np.array_equal(ts.instances[0].q0.numpy(), np.asarray(js.instances[0].q0))
    assert np.array_equal(ts.bvh.prim_order.numpy(), np.asarray(js.bvh.prim_order))
    with pytest.raises(NotImplementedError):
        bridge.scene_from_numpy(dict(tree, instance_count=0), "cpu", tile=256)


@pytest.mark.parametrize("channel", tmat.TEXTURE_COLUMNS)
def test_material_table_without_a_channel_is_refused(channel):
    """A table that leaves out a texture channel is refused; one that
    textures the channel keeps it."""
    mats = scene_tree(mesh_scene(subdivisions=1, use_bvh=True))["materials"]
    assert all((np.asarray(mats[ch]) < 0).all() for ch in tmat.TEXTURE_COLUMNS
               if ch != "kd_tex")
    tmat.materials_from_numpy(mats, "cpu")
    with pytest.raises(NotImplementedError):
        tmat.materials_from_numpy({k: v for k, v in mats.items() if k != channel}, "cpu")
    table = tmat.materials_from_numpy(dict(mats, **{channel: np.zeros_like(mats[channel])}),
                                      "cpu")
    assert getattr(table, channel).tolist() == [0] * len(mats["kind"])
    assert (table.has_bump if channel == "bump_tex"
            else channel[:-4] in table.tex_channels)


@pytest.mark.parametrize("make", [fog_scene, smoke_scene])
def test_tree_without_media_is_refused(make):
    """A tree must state its media: None (the mesh scene) or the table,
    which the port then carries array for array."""
    mesh = scene_tree(mesh_scene(subdivisions=1, use_bvh=True))
    assert mesh["media"] is None
    assert bridge.scene_from_numpy(mesh, "cpu", tile=256).media is None
    js = make()
    tree = scene_tree(js)
    media = bridge.scene_from_numpy(tree, "cpu", tile=256).media
    assert media.kinds_present == js.media.kinds_present
    for k in tmed.COLUMNS:
        assert np.array_equal(getattr(media, k).numpy(), np.asarray(getattr(js.media, k))), k
    for t in (tree, mesh):
        with pytest.raises(NotImplementedError):
            bridge.scene_from_numpy({k: v for k, v in t.items() if k != "media"}, "cpu",
                                    tile=256)
    with pytest.raises(NotImplementedError):
        bridge.scene_from_numpy(dict(tree, media={k: v for k, v in tree["media"].items()
                                                  if k != "grid"}), "cpu", tile=256)


def test_material_table_keeps_its_medium_interfaces():
    b = SceneBuilder()
    glass = b.glass(kr=0.0, kt=1.0, eta=1.0)
    b.medium_interface(glass, inside=-1, outside=0)
    b.matte(kd=0.5)
    b.add_sphere((0.0, 0.0, 0.0), 0.8, glass)
    b.set_homogeneous_medium(sigma_a=(0.4,) * 3, sigma_s=(0.0,) * 3)
    b.infinite_light(radiance=1.0)
    mats = scene_tree(b.build())["materials"]
    assert list(mats["med_inside"]) == [-1, -1] and list(mats["med_outside"]) == [0, -1]
    table = tmat.materials_from_numpy(mats, "cpu")
    assert table.med_inside.tolist() == [-1, -1] and table.med_outside.tolist() == [0, -1]
    plain = scene_tree(mesh_scene(subdivisions=1, use_bvh=True))["materials"]
    assert plain["med_inside"] is None and tmat.materials_from_numpy(plain, "cpu").med_inside is None
    for k in ("med_inside", "med_outside"):
        for m in (mats, plain):
            with pytest.raises(NotImplementedError):
                tmat.materials_from_numpy({c: v for c, v in m.items() if c != k}, "cpu")
