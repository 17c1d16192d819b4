"""Film reduction and splats (counterpart of pbrt_tpu/film/film.py): with
filter importance sampling each sample lands in its own pixel, so
developing an image is a weighted sum over the sample axis; light-traced
contributions (BDPT's t=1 strategies, MLT) land at arbitrary film
positions and are scattered into an unweighted splat image."""
from __future__ import annotations

import torch


def sums(radiance, weight, height, width):
    """radiance (S, H·W, 3), weight (S, H·W) → the per-pixel sums
    (acc (H, W, 3), wacc (H, W)) that a render accumulates over batches."""
    return ((radiance * weight[..., None]).sum(0).reshape(height, width, 3),
            weight.sum(0).reshape(height, width))


def resolve(acc, wacc, splats=None, splat_scale=1.0):
    """Per-pixel sums → the image, plus splat_scale × the splat image
    where one is given (BDPT: 1 / spp; MLT, which has no pixel samples:
    its mean luminance over the mutations a pixel)."""
    img = acc / torch.clamp(wacc[..., None], min=1e-10)
    if splats is not None:
        img = img + splat_scale * splats
    return img


def develop(radiance, weight, height, width):
    """radiance (S, H·W, 3), weight (S, H·W) → (H, W, 3) image."""
    return resolve(*sums(radiance, weight, height, width))


def add_splats(splats, pfilm, value, enabled=None):
    """splats (H, W, 3) with value (N, 3) added at the pixels of the
    continuous film positions pfilm (N, 2) (x, y) inside the film (and
    `enabled`, if given). A deterministic accumulate (`index_put` on the
    flat pixel index: sort and sum on the card, no atomics); its order
    of sums differs from XLA's scatter, so splat images are allclose to
    the reference's, not bit-equal. The lanes left out add their zero to
    a row of their own past the image, not to a clamped edge pixel: the
    card's accumulate is serial over a run of equal indices, and the lanes
    a BDPT frame leaves out (most of them) made one run. Returns the new
    splat image."""
    h, w = splats.shape[:2]
    x, y = pfilm[..., 0].reshape(-1), pfilm[..., 1].reshape(-1)
    n = x.shape[0]
    inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    if enabled is not None:
        inside = inside & enabled.reshape(-1)
    pix = torch.clamp(y.to(torch.int64), 0, h - 1) * w + torch.clamp(x.to(torch.int64), 0, w - 1)
    idx = torch.where(inside, pix, h * w + torch.arange(n, device=x.device))
    v = torch.where(inside[:, None], value.reshape(n, 3), 0.0)
    rows = torch.cat([splats.reshape(h * w, 3), splats.new_zeros((n, 3))])
    return rows.index_put((idx,), v, accumulate=True)[:h * w].reshape(h, w, 3)
