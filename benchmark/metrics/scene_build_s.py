"""Seconds to build the cell's scene: the host clock around the
configuration's scene builder (scenes.py, api.SceneBuilder, the cluster
build), ending in torch.cuda.synchronize()."""


def read(r):
    return r.scene_build_s
