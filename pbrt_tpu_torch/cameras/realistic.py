"""Realistic (lens-stack) camera (counterpart of
pbrt_tpu/cameras/realistic.py): spherical lens elements and an aperture
stop traced one element at a time over the whole wavefront, thick-lens
autofocus, and exit-pupil sampling. A ray the stack stops has weight 0
(generate_rays' `ok`).

The element table is kept as float32 values on the host, so each element's
step is a handful of tensor operations with the element's constants; the
exit-pupil bounds (P, 4) live on the camera's device."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as tf
from ..core import vecmath as vm
from ..core.types import f32, quadratic


class RealisticCamera(NamedTuple):
    camera_to_world: tf.Transform
    # per element, front (scene side) to back (film side), float32 values
    curvature_radius: tuple     # 0 marks the aperture stop
    thickness: tuple
    eta: tuple                  # medium on the film side of the surface
    aperture_radius: tuple
    z_front: tuple              # the surfaces' z, film at z = 0, scene at -z
    film_diag: float
    exit_pupil: torch.Tensor    # (P, 4) bounds (x0, y0, x1, y1) per film-radius bin
    shutter_open: float
    shutter_close: float
    resolution: tuple           # (h, w)


def _f32s(a):
    return tuple(float(x) for x in np.asarray(a, np.float32))


def make_realistic(camera_to_world, lens_elements, resolution, device, film_diag=0.035,
                   focus_distance=2.0, aperture_scale=1.0, shutter_open=0.0,
                   shutter_close=1.0):
    """lens_elements: rows of (curvature radius m, thickness m, eta,
    aperture diameter m), front to back; camera_to_world a (4, 4) host
    matrix. The stack is focused at focus_distance and its exit pupil
    computed on the host."""
    el = np.asarray(lens_elements, np.float64)
    ap = el[:, 3] * 0.5 * aperture_scale
    z = -np.cumsum(el[::-1, 1])[::-1]       # film at z = 0, elements toward -z
    cam = RealisticCamera(
        camera_to_world=tf.from_numpy(camera_to_world, device),
        curvature_radius=_f32s(el[:, 0]), thickness=_f32s(el[:, 1]),
        eta=_f32s(np.where(el[:, 2] == 0, 1.0, el[:, 2])), aperture_radius=_f32s(ap),
        z_front=_f32s(z), film_diag=f32(film_diag),
        exit_pupil=torch.zeros((1, 4), dtype=torch.float32, device=device),
        shutter_open=f32(shutter_open), shutter_close=f32(shutter_close),
        resolution=(int(resolution[0]), int(resolution[1])))
    cam = focus(cam, focus_distance)
    return cam._replace(exit_pupil=torch.as_tensor(exit_pupil_np(cam), device=device))


def _trace_element(cam, i, o, d, ok, from_film):
    """Ray (o, d) meets surface i: intersect, clip to its aperture and
    refract (a stop only clips). Rays that fail keep their o and d."""
    r, z_el, ap = cam.curvature_radius[i], cam.z_front[i], cam.aperture_radius[i]
    film_eta, scene_eta = cam.eta[i], (cam.eta[i - 1] if i > 0 else 1.0)
    dz = d[..., 2]
    if r == 0.0:
        t = (z_el - o[..., 2]) / torch.where(dz.abs() > 1e-9, dz, f32(1e-9))
        elem_ok = dz.abs() > 1e-9
    else:
        zc = f32(z_el + r)                     # the sphere's centre on the axis
        oc = torch.stack([o[..., 0], o[..., 1], o[..., 2] - zc], -1)
        has, t0, t1 = quadratic(vm.dot(d, d), 2.0 * vm.dot(oc, d), vm.dot(oc, oc) - f32(r * r))
        # the root on the element's side of its vertex
        t = torch.where((dz > 0) ^ (r < 0), t0, t1)
        elem_ok = has & (t > 0)
    p = o + t[..., None] * d
    elem_ok = elem_ok & (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] <= f32(ap * ap))
    if r != 0.0:
        n = vm.face_forward(vm.normalize(torch.stack([p[..., 0], p[..., 1], p[..., 2] - zc],
                                                     -1)), -d)
        eta = f32(film_eta / scene_eta) if from_film else f32(scene_eta / film_eta)
        refr_ok, wt = vm.refract(-d, n, torch.full_like(dz, eta))
        elem_ok = elem_ok & refr_ok
        d_new = torch.where(refr_ok[..., None], wt, d)
    else:
        d_new = d
    o = torch.where(elem_ok[..., None], p, o)
    d = torch.where(elem_ok[..., None], vm.normalize(d_new), d)
    return ok & elem_ok, o, d


def trace_from_film(cam, o, d):
    """Rays leaving the film (toward -z) through the stack, back to front.
    Returns (ok, o, d) on the scene side."""
    ok = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for i in range(len(cam.curvature_radius) - 1, -1, -1):
        ok, o, d = _trace_element(cam, i, o, d, ok, from_film=True)
    return ok, o, d


def trace_from_scene(cam, o, d):
    """Rays from the scene (toward +z) through the stack, front to back."""
    ok = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for i in range(len(cam.curvature_radius)):
        ok, o, d = _trace_element(cam, i, o, d, ok, from_film=False)
    return ok, o, d


def _axial_crossing(cam, focus_distance):
    """z where two near-axis rays from the on-axis point at -focus_distance
    cross the axis behind the stack (float32 trace on the host)."""
    x = 0.05 * float(np.min(cam.aperture_radius))
    z0, zf = -float(focus_distance), cam.z_front[0]
    o = torch.tensor([[0.0, 0.0, z0], [0.0, 0.0, z0]], dtype=torch.float32)
    aim = torch.tensor([[x * 0.5, 0.0, zf], [x, 0.0, zf]], dtype=torch.float32)
    ok, oo, dd = trace_from_scene(cam, o, vm.normalize(aim - o))
    if not bool(ok.all()):
        raise ValueError("lens stack does not pass near-axis rays; check the element table")
    z_cross = oo[:, 2] + (-oo[:, 0] / dd[:, 0]) * dd[:, 2]
    return float(z_cross.mean())


def focus(cam, focus_distance):
    """Thick-lens autofocus: shift the stack along z until the on-axis point
    at focus_distance images onto the film (z = 0); three fixed-point steps."""
    for _ in range(3):
        z_cross = np.float32(_axial_crossing(cam, focus_distance))
        cam = cam._replace(z_front=_f32s(np.asarray(cam.z_front, np.float32) - z_cross))
    return cam


def exit_pupil_np(cam, n_bins=32, n_samples=512):
    """(n_bins, 4) float32 bounds of the rear-element points that trace
    through the stack, per film-radius bin: n_samples points of
    numpy.random.RandomState(11) a bin, traced in float32 on the host."""
    rear_r, rear_z = cam.aperture_radius[-1], cam.z_front[-1]
    half_diag = np.float32(cam.film_diag) * np.float32(0.5)
    rng = np.random.RandomState(11)
    bounds = []
    for b in range(n_bins):
        r_film = float(np.float32((b + 0.5) / n_bins) * half_diag)
        xy = (rng.rand(n_samples, 2) * 2 - 1) * rear_r
        o = torch.as_tensor(np.stack([np.full(n_samples, r_film), np.zeros(n_samples),
                                      np.zeros(n_samples)], -1), dtype=torch.float32)
        target = torch.as_tensor(np.concatenate([xy, np.full((n_samples, 1), rear_z)], -1),
                                 dtype=torch.float32)
        ok = trace_from_film(cam, o, vm.normalize(target - o))[0].numpy()
        if ok.any():
            xs, ys = xy[ok, 0], xy[ok, 1]
            bounds.append([xs.min(), ys.min(), xs.max(), ys.max()])
        else:
            bounds.append([-rear_r, -rear_r, rear_r, rear_r])
    return np.asarray(bounds, np.float32)


def generate_rays(cam: RealisticCamera, pfilm, u_lens, u_time):
    """Rays from film points pfilm (..., 2) toward exit-pupil samples
    u_lens (..., 2), through the stack. Returns (o, d, time, ok)."""
    h, w = cam.resolution
    half_diag = np.float32(cam.film_diag) * np.float32(0.5)
    aspect = np.sqrt(np.float32(w) / np.float32(h))
    fw = float(half_diag * aspect * np.float32(2.0))
    fh = float(half_diag / aspect * np.float32(2.0))
    x = (pfilm[..., 0] / w - 0.5) * fw
    y = (pfilm[..., 1] / h - 0.5) * fh
    o_film = torch.stack([x, y, torch.zeros_like(x)], -1)
    # a point in this film radius's exit-pupil bounds, turned to the film
    # point's azimuth
    n_bins = cam.exit_pupil.shape[0]
    r_film = torch.sqrt(x * x + y * y)
    bidx = torch.clamp((r_film / float(half_diag) * n_bins).to(torch.int64), 0, n_bins - 1)
    bb = cam.exit_pupil[bidx]
    px = bb[..., 0] + u_lens[..., 0] * (bb[..., 2] - bb[..., 0])
    py = bb[..., 1] + u_lens[..., 1] * (bb[..., 3] - bb[..., 1])
    phi = torch.atan2(y, x)
    c, s = torch.cos(phi), torch.sin(phi)
    p_rear = torch.stack([c * px - s * py, s * px + c * py,
                          torch.full_like(x, cam.z_front[-1])], -1)
    ok, o_out, d_out = trace_from_film(cam, o_film, vm.normalize(p_rear - o_film))
    # lens space has the scene at -z, camera space at +z: turn 180° about y
    flip = torch.tensor([-1.0, 1.0, -1.0], dtype=o_out.dtype, device=o_out.device)
    o_w = cam.camera_to_world.apply_point(o_out * flip)
    d_w = vm.normalize(cam.camera_to_world.apply_vector(d_out * flip))
    time = cam.shutter_open + u_time * (cam.shutter_close - cam.shutter_open)
    return o_w, d_w, time, ok


# a simple double-Gauss-like demo lens (metres)
DEMO_LENS = [
    (0.0291, 0.00396, 1.67, 0.0253),
    (1.2563, 0.000127, 1.0, 0.0253),
    (0.0171, 0.00908, 1.67, 0.023),
    (-0.0396, 0.00176, 1.699, 0.0206),
    (0.0129, 0.00611, 1.0, 0.0177),
    (0.0, 0.00343, 0.0, 0.0095),      # aperture stop
    (-0.0134, 0.00196, 1.603, 0.0169),
    (0.0284, 0.00793, 1.658, 0.0191),
    (-0.0276, 0.000127, 1.0, 0.0191),
    (0.0796, 0.00518, 1.717, 0.0206),
    (-0.0514, 0.0450, 1.0, 0.0206),    # rear air gap = back focal distance
]
