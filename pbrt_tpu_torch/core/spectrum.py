"""RGB helpers and the sampled-spectrum tools (counterpart of
pbrt_tpu/core/spectrum.py): luminance, the XYZ matrices, the sRGB gamma,
the CIE curves of the Wyman–Sloan–Shirley multi-lobe Gaussian fit, the
RGB reflectance basis and Planck's law. The host-side tables are built in
numpy (float64, then float32) as the reference builds them."""
from __future__ import annotations

import numpy as np
import torch

from .types import f32

N_SPECTRAL_SAMPLES = 60
LAMBDA_START = 400.0
LAMBDA_END = 700.0

_WR, _WG, _WB = f32(0.212671), f32(0.715160), f32(0.072169)
RGB_TO_XYZ = np.array([[0.412453, 0.357580, 0.180423],
                       [0.212671, 0.715160, 0.072169],
                       [0.019334, 0.119193, 0.950227]])
XYZ_TO_RGB = np.array([[3.240479, -1.537150, -0.498535],
                       [-0.969256, 1.875991, 0.041556],
                       [0.055648, -0.204043, 1.057311]])


def luminance(s):
    """y() of an RGB triple."""
    return (s[..., 0] * _WR + s[..., 1] * _WG) + s[..., 2] * _WB


def _mat3(m, c):
    """(3, 3) host matrix m applied to c (..., 3)."""
    mt = torch.as_tensor(np.asarray(m, np.float32), device=c.device)
    return (c[..., None, :] * mt).sum(-1)


def rgb_to_xyz(c):
    return _mat3(RGB_TO_XYZ, c)


def xyz_to_rgb(c):
    return _mat3(XYZ_TO_RGB, c)


def gamma_correct(v):
    """Linear → sRGB."""
    v = torch.clamp(v, 0.0, 1.0)
    return torch.where(v <= f32(0.0031308), f32(12.92) * v,
                       f32(1.055) * torch.pow(v, f32(1.0 / 2.4)) - f32(0.055))


def inverse_gamma_correct(v):
    return torch.where(v <= f32(0.04045), v / f32(12.92),
                       torch.pow((v + f32(0.055)) / f32(1.055), f32(2.4)))


def _gauss(x, alpha, mu, s1, s2):
    s = np.where(x < mu, s1, s2)
    return alpha * np.exp(-((x - mu) ** 2) / (2 * s * s))


def cie_xyz_curves(lams):
    """(3, N) float32 CIE 1931 colour matching functions at wavelengths
    lams (nm), by the analytic multi-lobe Gaussian fit."""
    lams = np.asarray(lams, np.float64)
    x = (_gauss(lams, 1.056, 599.8, 37.9, 31.0)
         + _gauss(lams, 0.362, 442.0, 16.0, 26.7)
         + _gauss(lams, -0.065, 501.1, 20.4, 26.2))
    y = _gauss(lams, 0.821, 568.8, 46.9, 40.5) + _gauss(lams, 0.286, 530.9, 16.3, 31.1)
    z = _gauss(lams, 1.217, 437.0, 11.8, 36.0) + _gauss(lams, 0.681, 459.0, 26.0, 13.8)
    return np.stack([x, y, z], axis=0).astype(np.float32)


def spectral_lambdas(n=N_SPECTRAL_SAMPLES):
    """Centres of n equal bins over [LAMBDA_START, LAMBDA_END] (float64)."""
    edges = np.linspace(LAMBDA_START, LAMBDA_END, n + 1)
    return 0.5 * (edges[:-1] + edges[1:])


def sampled_to_xyz(s):
    """(..., N) sampled spectrum → (..., 3) XYZ by a Riemann sum
    normalised by the y-bar integral: a flat unit spectrum has Y = 1."""
    n = s.shape[-1]
    cmf = cie_xyz_curves(spectral_lambdas(n))             # (3, N) float32
    dl = (LAMBDA_END - LAMBDA_START) / n
    y_int = float(np.sum(cmf[1]) * dl)
    xyz = (s[..., None, :] * torch.as_tensor(cmf, device=s.device)).sum(-1)
    return xyz * f32(dl / y_int)


def rgb_reflectance_basis(n=N_SPECTRAL_SAMPLES):
    """(N, 3) float32 smooth spectral basis whose weighted sum reproduces
    an RGB reflectance through the spectrum → XYZ → RGB round trip: a
    flat spectrum and two sigmoid ramps, calibrated by one 3×3 solve
    against the CIE curves."""
    lams = spectral_lambdas(n)
    raw = np.stack([np.ones_like(lams),
                    1.0 / (1.0 + np.exp(-(lams - 575.0) / 30.0)),
                    1.0 / (1.0 + np.exp((lams - 510.0) / 30.0))], axis=1)
    cmf = cie_xyz_curves(lams).astype(np.float64)
    dl = (LAMBDA_END - LAMBDA_START) / n
    y_int = float(np.sum(cmf[1]) * dl)
    a = XYZ_TO_RGB @ (cmf @ raw * (dl / y_int))
    return (raw @ np.linalg.inv(a)).astype(np.float32)


def rgb_to_spectrum(c, n=N_SPECTRAL_SAMPLES):
    """(..., 3) RGB → (..., N) sampled spectrum, clamped at 0."""
    basis = torch.as_tensor(rgb_reflectance_basis(n), device=c.device)
    return torch.clamp((c[..., None, :] * basis).sum(-1), min=0.0)


def blackbody(lams_nm, temperature_k):
    """Planck's law, W/(m² sr nm), at wavelengths lams_nm (a float32
    tensor) and a temperature in kelvin."""
    lams = torch.as_tensor(lams_nm, dtype=torch.float32) * f32(1e-9)
    c = 299792458.0
    h = 6.62606957e-34
    kb = 1.3806488e-23
    e = torch.exp(f32(h * c) / ((lams * f32(kb)) * f32(temperature_k)))
    return (f32(2.0 * h * c * c) / (lams ** 5 * (e - 1.0))) * f32(1e-9)


def blackbody_normalized(lams_nm, temperature_k):
    """Planck's law scaled to 1 at the peak wavelength."""
    lambda_max = 2.8977721e-3 / temperature_k * 1e9
    return blackbody(lams_nm, temperature_k) / blackbody(lambda_max, temperature_k)
