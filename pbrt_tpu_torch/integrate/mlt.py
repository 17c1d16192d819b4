"""Metropolis light transport in primary sample space (counterpart of
pbrt_tpu/integrate/mlt.py).

A chain's state is its primary-sample vector u ∈ [0,1)^D; a path is
evaluated by the wavefront path tracer with a provider that reads its
dimensions from u (path.li's `provider`). Bootstrap N paths from hashed
uniforms, normalise by their mean luminance b, seed C chains in
proportion to luminance, then run the mutations (a large step with
probability P_LARGE, else a wrapped Gaussian small step), each with a
Metropolis accept and expected-value splats of both the proposal and the
current state. All C chains advance in lock-step as one wavefront."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import generate_rays_weighted
from ..core import samplers as smp
from ..core.rng import hash_combine, uniform_float
from ..core.sampling import Distribution1D
from ..core.spectrum import luminance
from ..core.types import ONE_MINUS_EPSILON, f32
from ..film import film as filmmod
from . import driver as drivermod
from . import path as pathmod

SIGMA = 0.01
P_LARGE = 0.3


class MLTConfig(NamedTuple):
    width: int = 64
    height: int = 64
    max_depth: int = 5
    n_bootstrap: int = 4096
    n_chains: int = 1024
    mutations_per_pixel: int = 16
    sampler: smp.SamplerConfig = smp.SamplerConfig(kind="random", spp=1)


def _n_dims(cfg):
    return smp.DIM_BOUNCE0 + cfg.max_depth * smp.DIMS_PER_BOUNCE + 2


def _array_provider(u_vec):
    """Provider reading path dimensions from (N, D) primary samples."""
    def sample1(bounce, slot):
        return u_vec[:, smp.bounce_dim(bounce, slot)]

    def sample2(bounce, slot):
        d0 = smp.bounce_dim(bounce, slot)
        return u_vec[:, d0:d0 + 2]

    return sample1, sample2


def _eval_path(scene, camera, cfg, u_vec):
    """Radiance, film position and path.li's stats for primary samples u
    (N, D): dims 0-1 the film, 2-3 the lens, 4 the time, then the path's."""
    h, w = cfg.height, cfg.width
    pfilm = torch.stack([u_vec[:, 0] * w, u_vec[:, 1] * h], -1)
    o, d, _, _ = generate_rays_weighted(camera, pfilm, u_vec[:, 2:4], u_vec[:, 4])
    n = u_vec.shape[0]
    rcfg = drivermod.RenderConfig(width=w, height=h, spp=1, max_depth=cfg.max_depth,
                                  sampler=cfg.sampler)
    zeros = torch.zeros((n,), dtype=torch.int64, device=u_vec.device)
    L, stats = pathmod.li(scene, o, d, zeros, zeros, rcfg, return_stats=True,
                          provider=_array_provider(u_vec))
    return L, pfilm, stats["rays_traced"]


def _bootstrap_u(cfg, i, d):
    """Bootstrap uniforms: hash(bootstrap index, dim)."""
    return uniform_float(0xB007, i, 0, d)


def _mutate(scene, camera, cfg, seed, m, chains, splat):
    """Mutation m of every chain: propose (a large step or a small one),
    evaluate, splat the proposal and the current state by expected value,
    then accept. chains holds u, L, p, lum, one row a chain. Returns the
    chains after the step, the splat image, the rays traced and the step's
    p_prop, lum_prop, accept, u_accept and take."""
    u_cur, L_cur, p_cur, lum_cur = chains["u"], chains["L"], chains["p"], chains["lum"]
    n, nd = u_cur.shape
    dev = u_cur.device
    ci = torch.arange(n, dtype=torch.int64, device=dev)
    dims = torch.arange(nd, dtype=torch.int64, device=dev)
    key = hash_combine(seed + 7, ci, m)
    is_large = (uniform_float(key, 0xAAAA) < P_LARGE)[:, None]
    fresh = uniform_float(key[:, None], 100 + dims, ci[:, None])
    # small step: a wrapped Gaussian perturbation
    g1 = uniform_float(key[:, None], 500 + dims, ci[:, None])
    g2 = uniform_float(key[:, None], 900 + dims, ci[:, None])
    normal = torch.sqrt(-2.0 * torch.log(torch.clamp(g1, min=f32(1e-10)))) \
        * torch.cos(f32(2.0 * np.pi) * g2)
    perturbed = torch.remainder(u_cur + SIGMA * normal, 1.0)
    u_prop = torch.clamp(torch.where(is_large, fresh, perturbed), 0.0, ONE_MINUS_EPSILON)

    L_prop, p_prop, rays = _eval_path(scene, camera, cfg, u_prop)
    lum_prop = luminance(L_prop)
    accept = torch.clamp(lum_prop / torch.clamp(lum_cur, min=f32(1e-12)), max=1.0)

    # expected-value splats of the proposal and the current state
    w_prop = accept / torch.clamp(lum_prop, min=f32(1e-12))
    w_cur = (1.0 - accept) / torch.clamp(lum_cur, min=f32(1e-12))
    splat = filmmod.add_splats(splat, p_prop, L_prop * w_prop[:, None], enabled=lum_prop > 0)
    splat = filmmod.add_splats(splat, p_cur, L_cur * w_cur[:, None], enabled=lum_cur > 0)

    u_accept = uniform_float(key, 0xBBBB)
    take = u_accept < accept
    chains = dict(u=torch.where(take[:, None], u_prop, u_cur),
                  L=torch.where(take[:, None], L_prop, L_cur),
                  p=torch.where(take[:, None], p_prop, p_cur),
                  lum=torch.where(take, lum_prop, lum_cur))
    step = dict(p_prop=p_prop, lum_prop=lum_prop, accept=accept, u_accept=u_accept, take=take)
    return chains, splat, rays, step


def render(scene, camera, cfg: MLTConfig, seed=0, return_stats=False):
    """MLT render → (H, W, 3); with `return_stats`, (image,
    {"rays_traced"})."""
    h, w = cfg.height, cfg.width
    nd = _n_dims(cfg)
    dev = scene.device

    # bootstrap
    bi = torch.arange(cfg.n_bootstrap, dtype=torch.int64, device=dev)
    u_boot = torch.stack([_bootstrap_u(cfg, bi, dd) for dd in range(nd)], -1)
    L_boot, _, rays = _eval_path(scene, camera, cfg, u_boot)
    lum = luminance(L_boot)
    b = lum.mean()
    dist = Distribution1D.build(lum + f32(1e-12))

    # seed chains in proportion to luminance
    ci = torch.arange(cfg.n_chains, dtype=torch.int64, device=dev)
    seed_idx, _, _ = dist.sample_discrete(uniform_float(seed + 1, ci))
    u_cur = u_boot[seed_idx]

    n_mutations = (cfg.mutations_per_pixel * h * w) // cfg.n_chains
    splat = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    L_cur, p_cur, r = _eval_path(scene, camera, cfg, u_cur)
    rays = rays + r
    chains = dict(u=u_cur, L=L_cur, p=p_cur, lum=luminance(L_cur))
    for m in range(n_mutations):
        chains, splat, r, _ = _mutate(scene, camera, cfg, seed, m, chains, splat)
        rays = rays + r

    # no pixel samples: the image is the scaled splats alone
    total_samples = n_mutations * cfg.n_chains
    img = filmmod.resolve(torch.zeros_like(splat), torch.zeros((h, w), dtype=torch.float32, device=dev), splat,
                          b / max(total_samples / (h * w), 1e-12))
    return (img, {"rays_traced": rays}) if return_stats else img
