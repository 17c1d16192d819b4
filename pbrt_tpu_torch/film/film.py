"""Film reduction (counterpart of pbrt_tpu/film/film.py): with filter
importance sampling each sample lands in its own pixel, so developing an
image is a weighted sum over the sample axis."""
from __future__ import annotations

import torch


def develop(radiance, weight, height, width):
    """radiance (S, H·W, 3), weight (S, H·W) → (H, W, 3) image."""
    acc = (radiance * weight[..., None]).sum(0).reshape(height, width, 3)
    wacc = weight.sum(0).reshape(height, width)
    return acc / torch.clamp(wacc[..., None], min=1e-10)
