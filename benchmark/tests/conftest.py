"""The benchmark's CPU tests: python -m pytest benchmark/tests -q
(run from the checkout's root). Tests marked `cuda` run the control at
the cells' own sizes and skip without a card."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

# small shapes for the CPU: 32x32 at 4 spp (4,096 lanes, so the path compacts)
SMALL_TRAFFIC = {"width": 32, "height": 32, "spp": 4, "samples_per_batch": 0,
                 "warmup_frames": 1, "traced_frames": 2, "warmup_steps": 1, "traced_steps": 2}


def small(cell):
    from pbench import manifest
    c = manifest.cell(manifest.load(), cell)
    traffic = dict(SMALL_TRAFFIC)
    if manifest.traffic(c["traffic"])["kind"] == "train":
        traffic.update(width=64, height=64, spp=1)
    return {"traffic": traffic}


@pytest.fixture
def cpu_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
