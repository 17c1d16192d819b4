"""Render driver (counterpart of pbrt_tpu/integrate/driver.py and the
single-device lane raygen of pbrt_tpu/dist/sharding._render_lanes).

The wavefront is (samples, H·W) lanes: filter-importance-sampled film
positions, camera rays, the integrator `li`, and a reduction over the
sample axis. Every random number is keyed by (pixel, sample, dim)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import trace
from ..cameras import generate_rays_weighted
from ..core import samplers as smp
from ..film import film as filmmod
from ..film import filters as filtmod


class RenderConfig(NamedTuple):
    width: int = 64
    height: int = 64
    spp: int = 4
    max_depth: int = 5
    sampler: smp.SamplerConfig = smp.SamplerConfig()
    filter: filtmod.Filter = filtmod.Filter()
    samples_per_batch: int = 0      # 0 → all spp in one wavefront
    light_strategy: str = "uniform"
    # texture filtering along the footprint's major axis: 1 = one
    # stochastic tap a sample, > 1 = that many midpoint taps averaged a
    # lookup (low-spp previews; each tap costs a texture evaluation)
    aniso_taps: int = 1


def lane_ids(cfg: RenderConfig, sample_lo, sample_hi, device):
    """(pixel_id, sample_idx), both (S, H·W) int64."""
    hw = cfg.height * cfg.width
    s = sample_hi - sample_lo
    pixel_id = torch.arange(hw, dtype=torch.int64, device=device)[None, :].expand(s, hw)
    sample_idx = (torch.arange(s, dtype=torch.int64, device=device)
                  + sample_lo)[:, None].expand(s, hw)
    return pixel_id.contiguous(), sample_idx.contiguous()


@trace.spanned("driver.camera")
def camera_rays(camera, cfg: RenderConfig, pixel_id, sample_idx):
    """Film sampling and camera raygen for explicit lanes. Returns
    (o, d, camera weight, filter weight)."""
    w = cfg.width
    u_film = smp.sample_2d(cfg.sampler, pixel_id, sample_idx, smp.DIM_FILM)
    px = (pixel_id % w).to(torch.float32)
    py = torch.div(pixel_id, w, rounding_mode="floor").to(torch.float32)
    off, fw = filtmod.sample_offset(cfg.filter, u_film)
    pfilm = torch.stack([px + 0.5 + off[..., 0], py + 0.5 + off[..., 1]], -1)
    u_lens = smp.sample_2d(cfg.sampler, pixel_id, sample_idx, smp.DIM_LENS)
    u_time = smp.sample_1d(cfg.sampler, pixel_id, sample_idx, smp.DIM_TIME)
    o, d, _t, cw = generate_rays_weighted(camera, pfilm, u_lens, u_time)
    return o, d, cw, fw


def render_lanes(scene, camera, cfg: RenderConfig, li_fn, pixel_id, sample_idx):
    """Render explicit lanes. li_fn(scene, o, d, pixel_id, sample_idx)
    returns radiance or (radiance, stats). Returns (result, weight)."""
    o, d, cw, fw = camera_rays(camera, cfg, pixel_id, sample_idx)
    out = li_fn(scene, o, d, pixel_id, sample_idx)
    if isinstance(out, tuple):
        out = (out[0] * cw[..., None],) + tuple(out[1:])
    else:
        out = out * cw[..., None]
    return out, fw * torch.ones(pixel_id.shape, dtype=torch.float32,
                                device=pixel_id.device)


def render_batch(scene, camera, cfg: RenderConfig, li_fn, sample_lo, sample_hi):
    """Render sample indices [sample_lo, sample_hi) of every pixel.
    Returns (radiance (S, H·W, 3), weight (S, H·W))."""
    pixel_id, sample_idx = lane_ids(cfg, sample_lo, sample_hi, scene.device)
    return render_lanes(scene, camera, cfg, li_fn, pixel_id, sample_idx)


def accumulate(scene, camera, cfg: RenderConfig, li_fn, acc, wacc, sample_lo=0):
    """Add samples [sample_lo, spp) to the film sums acc (H, W, 3) and
    wacc (H, W), one batch of samples_per_batch at a time, each reduced to
    per-pixel sums at once as the reference does, so memory does not grow
    with spp. Yields (next sample, acc, wacc, the batch's rays_traced or
    None) after each batch."""
    h, w = cfg.height, cfg.width
    batch = cfg.samples_per_batch or cfg.spp
    for lo in range(sample_lo, cfg.spp, batch):
        hi = min(lo + batch, cfg.spp)
        r, wt = render_batch(scene, camera, cfg, li_fn, lo, hi)
        rays = None
        if isinstance(r, tuple):
            r, stats = r
            rays = stats["rays_traced"]
        with trace.span("driver.film"):
            a, b = filmmod.sums(r, wt, h, w)
            acc = acc + a
            wacc = wacc + b
        yield hi, acc, wacc, rays


@trace.spanned("driver.render")
def render(scene, camera, cfg: RenderConfig, li_fn):
    """Full render → (H, W, 3) image. With an li_fn that returns
    (radiance, stats), returns (image, {"rays_traced": summed over the
    sample batches})."""
    acc = torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32, device=scene.device)
    wacc = torch.zeros((cfg.height, cfg.width), dtype=torch.float32, device=scene.device)
    rays = None
    for _, acc, wacc, r in accumulate(scene, camera, cfg, li_fn, acc, wacc):
        if r is not None:
            rays = r if rays is None else rays + r
    with trace.span("driver.film"):
        img = filmmod.resolve(acc, wacc)
    return img if rays is None else (img, {"rays_traced": rays})
