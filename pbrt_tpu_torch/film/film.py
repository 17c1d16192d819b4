"""Film reduction (counterpart of pbrt_tpu/film/film.py): with filter
importance sampling each sample lands in its own pixel, so developing an
image is a weighted sum over the sample axis."""
from __future__ import annotations

import torch


def sums(radiance, weight, height, width):
    """radiance (S, H·W, 3), weight (S, H·W) → the per-pixel sums
    (acc (H, W, 3), wacc (H, W)) that a render accumulates over batches."""
    return ((radiance * weight[..., None]).sum(0).reshape(height, width, 3),
            weight.sum(0).reshape(height, width))


def resolve(acc, wacc):
    """Per-pixel sums → the image."""
    return acc / torch.clamp(wacc[..., None], min=1e-10)


def develop(radiance, weight, height, width):
    """radiance (S, H·W, 3), weight (S, H·W) → (H, W, 3) image."""
    return resolve(*sums(radiance, weight, height, width))
