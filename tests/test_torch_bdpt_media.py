"""The PyTorch port's bidirectional path tracer against pbrt_tpu in
config 4's fog box (σa 0.08, σs 0.45, g 0.2): the walks' medium vertices
(HG phase, no cos in their densities) and the Tr of every connection.
8×8, 2 spp, depth 2, random sampler; held as tests/test_torch_bdpt.py
holds the area-lit box (the image at rtol 1e-4, atol 1e-6 and the pixel
check, every strategy's sums at rtol 1e-4). Both walks make medium
vertices."""
from scenes.volumetric import fog_scene as jfog_scene
from scenes.volumetric import volumetric_camera as jcamera
from tests.test_torch_bdpt import RES, check_bdpt
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)

from pbrt_tpu_torch import scenes as tscenes
from pbrt_tpu_torch.integrate import bdpt as tbdpt


def test_bdpt_fog_matches_jax(monkeypatch):
    medium_vertices = []
    walk = tbdpt._walk

    def counting_walk(*args, **kw):
        path = walk(*args, **kw)
        medium_vertices.append(sum(int((v == tbdpt.VTX_MEDIUM).sum()) for v in path.vtype))
        return path

    monkeypatch.setattr(tbdpt, "_walk", counting_walk)
    strat = check_bdpt(jfog_scene(), tscenes.fog_scene(device="cpu", tile=256),
                       jcamera((RES, RES)), tscenes.volumetric_camera((RES, RES), "cpu"), 2)
    assert len(medium_vertices) == 4 and min(medium_vertices) > 0     # 2 spp × 2 walks
    assert all(strat[k][0] > 0 for k in ((0, 3), (1, 2), (2, 2), (2, 1)))
