"""pbrt_tpu_torch — the PyTorch/CUDA port of pbrt_tpu for NVIDIA Hopper.

The package mirrors pbrt_tpu's layout (core, cameras, film, geom, shade,
lights, integrate, kernels) with PyTorch idiom: plain functions on
float32 tensors and an explicit device. The tile×cluster ray tracer's two
hot kernels (coverage and closest hit) are hand-written CUDA C++
(kernels/csrc/cluster.cu), each with a plain PyTorch version beside it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
There is no silent fallback: asking for CUDA without a card raises.
"""
from __future__ import annotations

import torch

# full float32 everywhere: the Plücker sign tests flip under TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.
    Raises when CUDA is asked for and no card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("pbrt_tpu_torch: CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run the plain versions")
    return dev
