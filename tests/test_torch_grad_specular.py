"""The port's gradients against jax.grad of pbrt_tpu on the specular
Cornell box (mirror and glass spheres) through path, 16×16, 2 spp:
tests/test_torch_grad.py's comparison and tolerances, in a file of its
own. Depth 2, not 3: the JAX reference of the glass path traces and
compiles for 55–67 s at depth 3 (the glass sampling is most of its
graph), over the minute a test file may take; at depth 2 a camera ray
still reaches the light through the mirror and through both faces of the
glass sphere."""
from tests.test_torch_grad import check_against_jax
from tests.test_torch_media import one_torch_thread  # noqa: F401


def test_specular_path_gradients_match_jax():
    gt = check_against_jax(True, "path", depth=2)
    assert gt["materials"]["kr"].any()     # the mirror's kr reaches the image
