"""Sampled-spectrum render mode (counterpart of
pbrt_tpu/integrate/spectral.py).

Light transport is linear and independent per wavelength (no dispersion:
every eta is constant in λ), so a render of 3·K wavelength bins is K RGB
renders whose material reflectances and light emissions are the RGB
reflectance basis's spectra at that render's three bins. The stack of
bins converts to XYZ with the CIE curves and then to linear sRGB.

As in the reference, a texel's RGB scales the spectralised material
constant per bin (the colour is projected on the basis twice on textured
materials)."""
from __future__ import annotations

import dataclasses

import torch

from ..core import spectrum as spec
from . import driver as drivermod


def _spectralize_scene(scene, lam_slice, n_bins):
    """The scene with its reflectances and emissions at three wavelength
    bins (lam_slice: a slice of width 3 of the n_bins axis)."""
    b3 = torch.as_tensor(spec.rgb_reflectance_basis(n_bins)[lam_slice], device=scene.device)

    def to_bins(c):
        return torch.clamp((c[..., None, :] * b3).sum(-1), min=0.0)

    mats = scene.materials
    mats = dataclasses.replace(mats, kd=to_bins(mats.kd), ks=to_bins(mats.ks),
                               kr=to_bins(mats.kr), kt=to_bins(mats.kt))
    lights = dataclasses.replace(scene.lights, emit=to_bins(scene.lights.emit),
                                 env_image=to_bins(scene.lights.env_image))
    return dataclasses.replace(scene, materials=mats, lights=lights)


def render_spectral(scene, camera, cfg, make_li, n_bins=12):
    """Spectral render → (spectral (H, W, n_bins), rgb (H, W, 3)); n_bins
    is a multiple of 3 (three bins ride each RGB render). With an li that
    returns (radiance, stats), also returns {"rays_traced"} summed over
    the n_bins / 3 renders."""
    if n_bins % 3:
        raise ValueError(f"n_bins={n_bins}: expected a multiple of 3")
    stacks, rays = [], None
    for k in range(0, n_bins, 3):
        out = drivermod.render(_spectralize_scene(scene, slice(k, k + 3), n_bins), camera,
                               cfg, make_li(cfg))
        if isinstance(out, tuple):
            out, stats = out
            rays = stats["rays_traced"] if rays is None else rays + stats["rays_traced"]
        stacks.append(out)
    spectral = torch.cat(stacks, -1)
    rgb = torch.clamp(spec.xyz_to_rgb(spec.sampled_to_xyz(spectral)), min=0.0)
    if rays is None:
        return spectral, rgb
    return spectral, rgb, {"rays_traced": rays}
