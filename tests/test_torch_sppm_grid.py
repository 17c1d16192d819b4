"""The PyTorch port's SPPM hash-grid gather against pbrt_tpu, with
max_photons_per_cell=2 so that the cap drops photons: the image and
photons_dropped, held as tests/test_torch_sppm.py holds the dense
gather's (8×8, 2 iterations of 1,024 photons, depth 3, rtol 1e-4, atol
1e-6 and the pixel check). The photons are stably sorted by cell, so the
two packages keep the same photons of a full cell."""
from tests.test_torch_media import one_torch_thread  # noqa: F401 (autouse)
from tests.test_torch_sppm import check_sppm


def test_sppm_grid_matches_jax():
    check_sppm("grid", 2)
