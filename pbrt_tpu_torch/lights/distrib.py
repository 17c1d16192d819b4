"""Light-selection distributions: power and spatial (counterpart of
pbrt_tpu/lights/distrib.py). Power is a Distribution1D over the lights'
approximate emitted power. Spatial voxelizes the world box and estimates
each light's contribution at jittered points of each voxel, all voxels in
one batched pass; a lookup is a gather of the voxel's CDF."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.rng import uniform_float
from ..core.sampling import Distribution1D
from ..core.spectrum import luminance
from ..core.types import f32
from . import lights as lightsmod


class SpatialLightDistribution(NamedTuple):
    grid_cdf: torch.Tensor    # (V, L+1) per-voxel CDF
    grid_func: torch.Tensor   # (V, L)
    resolution: tuple         # (nz, ny, nx)
    world_min: torch.Tensor   # (3,)
    world_ext: torch.Tensor   # (3,)


def power_distribution(lights, world_radius):
    return Distribution1D.build(lightsmod.power(lights, world_radius))


def spatial_from_numpy(arrs, device):
    """A SpatialLightDistribution from numpy arrays (grid_cdf, grid_func,
    resolution, world_min, world_ext); None gives None."""
    if arrs is None:
        return None
    t = lambda k: torch.as_tensor(np.asarray(arrs[k], np.float32), device=device)  # noqa: E731
    return SpatialLightDistribution(t("grid_cdf"), t("grid_func"),
                                    tuple(int(x) for x in arrs["resolution"]),
                                    t("world_min"), t("world_ext"))


def build_spatial(scene, lights, resolution=(8, 8, 8), n_estimate=32, seed=0):
    """Per-voxel light importance: each light's mean luminance/pdf over
    n_estimate jittered points of the voxel (occlusion ignored), floored
    at a tenth of the voxel's mean so no light has probability 0."""
    nz, ny, nx = resolution
    v = nz * ny * nx
    dev = scene.device
    wmin = scene.world_center - scene.world_radius
    ext = torch.full((3,), 2.0 * scene.world_radius, dtype=torch.float32, device=dev)
    zi, yi, xi = torch.meshgrid(torch.arange(nz, device=dev), torch.arange(ny, device=dev),
                                torch.arange(nx, device=dev), indexing="ij")
    base = torch.stack([xi, yi, zi], -1).reshape(v, 3).to(torch.float32)
    res_f = torch.tensor([nx, ny, nz], dtype=torch.float32, device=dev)
    vid = torch.arange(v, dtype=torch.int64, device=dev)
    func = torch.zeros((v, lights.count), dtype=torch.float32, device=dev)
    for k in range(n_estimate):
        u = torch.stack([uniform_float(seed, vid, k, ax) for ax in range(3)], -1)
        p = wmin + (base + u) / res_f * ext
        for li in range(lights.count):
            lt = torch.full((v,), li, dtype=torch.int64, device=dev)
            u2 = torch.stack([uniform_float(seed + 1, vid, k, 10 + li * 2 + ax)
                              for ax in range(2)], -1)
            ls = lightsmod.sample_li(lights, scene, lt, p, u2, scene.world_radius)
            contrib = torch.where(ls["pdf"] > 0, luminance(ls["li"])
                                  / torch.clamp(ls["pdf"], min=f32(1e-12)), 0.0)
            func[:, li] += contrib
    func = func / n_estimate
    func = torch.maximum(func, 0.1 * func.mean(-1, keepdim=True) + f32(1e-9))
    dist = Distribution1D.build(func)
    return SpatialLightDistribution(grid_cdf=dist.cdf, grid_func=dist.func,
                                    resolution=tuple(resolution), world_min=wmin,
                                    world_ext=ext)


def voxel_of(sd: SpatialLightDistribution, p):
    """Voxel index of points p (N, 3)."""
    nz, ny, nx = sd.resolution
    q = torch.clamp((p - sd.world_min) / sd.world_ext, 0.0, f32(0.9999))
    xi = (q[..., 0] * nx).to(torch.int64)
    yi = (q[..., 1] * ny).to(torch.int64)
    zi = (q[..., 2] * nz).to(torch.int64)
    return (zi * ny + yi) * nx + xi


def spatial_lookup_sample(sd: SpatialLightDistribution, p, u):
    """A light for shading points p (N, 3): (light index, pmf)."""
    vi = voxel_of(sd, p)
    func = sd.grid_func[vi]
    d = Distribution1D(func, sd.grid_cdf[vi], func.sum(-1) / func.shape[-1])
    idx, pmf, _ = d.sample_discrete(u)
    return idx, pmf
