"""Cameras: perspective (pinhole or thin lens), orthographic and
environment (latitude-longitude) ray generation, the pixel ray cone, and
the perspective camera's importance functions We, pdf_we and sample_wi of
BDPT's t=1 strategies (counterpart of pbrt_tpu/cameras/cameras.py). The
realistic lens-stack camera is in realistic.py; generate_rays dispatches
on the kind."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as tf
from ..core import vecmath as vm
from ..core.sampling import concentric_sample_disk
from ..core.types import PI, f32


class PerspectiveCamera(NamedTuple):
    camera_to_world: tf.Transform
    raster_to_camera: tf.Transform
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    area: float                 # film area at z=1 in camera space
    resolution: tuple           # (h, w)


class OrthographicCamera(NamedTuple):
    camera_to_world: tf.Transform
    raster_to_camera: tf.Transform
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    resolution: tuple


class EnvironmentCamera(NamedTuple):
    camera_to_world: tf.Transform
    shutter_open: float
    shutter_close: float
    resolution: tuple


def _screen_window(h, w):
    aspect = w / h
    if aspect > 1.0:
        return (-aspect, aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / aspect, 1.0 / aspect)


def _raster_to_screen_np(h, w):
    x0, x1, y0, y1 = _screen_window(h, w)
    return (tf.translate_np([x0, y1, 0.0]) @ tf.scale_np([x1 - x0, y0 - y1, 1.0])
            @ tf.scale_np([1.0 / w, 1.0 / h, 1.0]))


def make_perspective(camera_to_world, fov_deg, resolution, device,
                     lens_radius=0.0, focal_distance=1e6, shutter_open=0.0,
                     shutter_close=1.0):
    """camera_to_world: (4, 4) host matrix. A lens_radius > 0 gives thin-lens
    depth of field focused at focal_distance."""
    h, w = resolution
    cam2screen = tf.perspective_np(fov_deg, 1e-2, 1000.0)
    r2c = np.linalg.inv(cam2screen) @ _raster_to_screen_np(h, w)
    x0, x1, y0, y1 = _screen_window(h, w)
    tan_half = np.tan(np.deg2rad(fov_deg) / 2.0)
    area = abs((x1 - x0) * (y1 - y0)) * tan_half * tan_half
    return PerspectiveCamera(
        camera_to_world=tf.from_numpy(camera_to_world, device),
        raster_to_camera=tf.from_numpy(r2c, device),
        lens_radius=f32(lens_radius), focal_distance=f32(focal_distance),
        shutter_open=f32(shutter_open), shutter_close=f32(shutter_close),
        area=f32(area), resolution=(int(h), int(w)))


def make_orthographic(camera_to_world, resolution, device, lens_radius=0.0,
                      focal_distance=1e6, shutter_open=0.0, shutter_close=1.0):
    """Parallel rays along the camera's +z from the screen window [-1, 1]
    (the shorter side) of the camera's z = 0 plane."""
    h, w = resolution
    r2c = np.linalg.inv(tf.orthographic_np(0.0, 1.0)) @ _raster_to_screen_np(h, w)
    return OrthographicCamera(
        camera_to_world=tf.from_numpy(camera_to_world, device),
        raster_to_camera=tf.from_numpy(r2c, device),
        lens_radius=f32(lens_radius), focal_distance=f32(focal_distance),
        shutter_open=f32(shutter_open), shutter_close=f32(shutter_close),
        resolution=(int(h), int(w)))


def make_environment(camera_to_world, resolution, device, shutter_open=0.0,
                     shutter_close=1.0):
    """Every direction from the camera's origin: film y is θ (from the
    camera's +y), film x is φ."""
    h, w = resolution
    return EnvironmentCamera(tf.from_numpy(camera_to_world, device), f32(shutter_open),
                             f32(shutter_close), (int(h), int(w)))


def cone_start(camera):
    """(width0, spread) of the pixel ray cone as float32 values: a pinhole
    or thin lens spreads by the pixel's angle, an orthographic camera
    starts a pixel wide and does not spread, the environment and realistic
    cameras spread by π / h."""
    h, w = camera.resolution
    x0, x1, y0, y1 = _screen_window(h, w)
    if isinstance(camera, PerspectiveCamera):
        area = np.float32(camera.area)
        tan_half = np.sqrt(area / np.float32(abs((x1 - x0) * (y1 - y0))))
        return 0.0, float(np.float32(np.float32(y1 - y0) * tan_half / np.float32(h)))
    if isinstance(camera, OrthographicCamera):
        return f32((y1 - y0) / h), 0.0
    return 0.0, float(np.float32(PI) / np.float32(h))


def _time(camera, u_time):
    return camera.shutter_open + u_time * (camera.shutter_close - camera.shutter_open)


def generate_rays(camera, pfilm, u_lens, u_time):
    """Batched ray generation. pfilm: (..., 2) continuous raster positions;
    u_lens: (..., 2); u_time: (...,). Returns world-space (o, d, time).
    (generate_rays_weighted also gives the realistic camera's vignetting.)"""
    return generate_rays_weighted(camera, pfilm, u_lens, u_time)[:3]


def generate_rays_weighted(camera, pfilm, u_lens, u_time):
    """Batched ray generation with a per-ray weight: 1, or for the
    realistic camera 0 where the lens stack stops the ray. Returns
    (o, d, time, weight)."""
    from . import realistic
    if isinstance(camera, realistic.RealisticCamera):
        o, d, time, ok = realistic.generate_rays(camera, pfilm, u_lens, u_time)
        return o, d, time, ok.to(torch.float32)
    ones = torch.ones(pfilm.shape[:-1], dtype=torch.float32, device=pfilm.device)
    time = _time(camera, u_time)
    if isinstance(camera, EnvironmentCamera):
        h, w = camera.resolution
        theta = PI * pfilm[..., 1] / h
        phi = 2.0 * PI * pfilm[..., 0] / w
        d_cam = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                             torch.sin(theta) * torch.sin(phi)], -1)
        c2w = camera.camera_to_world
        return (c2w.apply_point(torch.zeros_like(d_cam)),
                vm.normalize(c2w.apply_vector(d_cam)), time, ones)
    if not isinstance(camera, (PerspectiveCamera, OrthographicCamera)):
        raise ValueError(f"no ray generation for a {type(camera).__name__}")
    p_raster = torch.cat([pfilm, torch.zeros_like(pfilm[..., :1])], -1)
    p_cam = camera.raster_to_camera.apply_point(p_raster)
    if isinstance(camera, PerspectiveCamera):
        o_cam = torch.zeros_like(p_cam)
        d_cam = vm.normalize(p_cam)
    else:
        o_cam = p_cam
        d_cam = torch.zeros_like(p_cam)
        d_cam[..., 2] = 1.0
    if camera.lens_radius > 0.0:
        # thin lens: from a point on the lens through the ray's point on the
        # plane of focus
        p_lens = camera.lens_radius * concentric_sample_disk(u_lens)
        ft = camera.focal_distance / torch.clamp(d_cam[..., 2], min=f32(1e-8))
        p_focus = o_cam + ft[..., None] * d_cam
        o_cam = torch.cat([p_lens, o_cam[..., 2:3]], -1)
        d_cam = vm.normalize(p_focus - o_cam)
    o = camera.camera_to_world.apply_point(o_cam)
    d = vm.normalize(camera.camera_to_world.apply_vector(d_cam))
    return o, d, time, ones


# ------------------------------------------------- importance (BDPT t=1)

def _perspective_only(camera, what):
    """The importance functions read a perspective camera's own fields."""
    if not isinstance(camera, PerspectiveCamera):
        raise ValueError(f"{what} is defined for the perspective camera only, "
                         f"not for a {type(camera).__name__}")


def _lens_area(camera: PerspectiveCamera):
    return PI * camera.lens_radius ** 2 if camera.lens_radius > 0.0 else 1.0


def _axis(camera: PerspectiveCamera, like):
    """The camera's viewing axis in world space."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=like.device)
    return camera.camera_to_world.apply_vector(z)


def camera_we(camera: PerspectiveCamera, o, d):
    """Importance We of rays (o, d) (..., 3) leaving the camera, and
    their raster positions. Returns (we (...,), p_raster (..., 2), valid):
    valid where the ray faces forward and lands inside the film."""
    _perspective_only(camera, "camera_we")
    c2w = camera.camera_to_world
    cos_theta = vm.dot(d, _axis(camera, d))
    valid = cos_theta > 0.0
    ct = torch.clamp(cos_theta, min=f32(1e-6))
    focus = camera.focal_distance if camera.lens_radius > 0.0 else 1.0
    p_focus = o + (focus / ct)[..., None] * d
    p_cam = c2w.inverse().apply_point(p_focus)
    p_cam = p_cam / torch.clamp(p_cam[..., 2:3], min=f32(1e-8))
    p_raster = camera.raster_to_camera.inverse().apply_point(p_cam)
    h, w = camera.resolution
    valid = valid & (p_raster[..., 0] >= 0) & (p_raster[..., 0] < w) \
        & (p_raster[..., 1] >= 0) & (p_raster[..., 1] < h)
    ct2 = ct * ct
    we = 1.0 / (camera.area * _lens_area(camera) * (ct2 * ct2))
    return torch.where(valid, we, 0.0), p_raster[..., :2], valid


def camera_pdf_we(camera: PerspectiveCamera, o, d):
    """(pdf_pos, pdf_dir) of a camera ray (o, d): per lens area and per
    solid angle; 0 where the ray misses the film."""
    _perspective_only(camera, "camera_pdf_we")
    _, _, valid = camera_we(camera, o, d)
    cos_theta = torch.clamp(vm.dot(d, _axis(camera, d)), min=f32(1e-6))
    pdf_dir = 1.0 / (camera.area * (cos_theta * cos_theta * cos_theta))
    return (torch.where(valid, 1.0 / _lens_area(camera), 0.0),
            torch.where(valid, pdf_dir, 0.0))


def camera_sample_wi(camera: PerspectiveCamera, p_ref, u_lens):
    """A direction from p_ref (N, 3) toward a point on the lens. Returns
    (wi, we, pdf per solid angle at p_ref, p_raster, p_lens_world); we
    and pdf are 0 where the connection misses the film."""
    _perspective_only(camera, "camera_sample_wi")
    n = p_ref.shape[:-1]
    if camera.lens_radius > 0.0:
        p_lens = camera.lens_radius * concentric_sample_disk(u_lens)
    else:
        p_lens = torch.zeros(n + (2,), dtype=torch.float32, device=p_ref.device)
    p_lens_world = camera.camera_to_world.apply_point(
        torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], -1))
    wi = p_lens_world - p_ref
    dist = vm.length(wi)
    wi = wi / torch.clamp(dist[..., None], min=f32(1e-8))
    cos = vm.absdot(_axis(camera, wi), -wi)
    pdf = (dist * dist) / torch.clamp(cos * _lens_area(camera), min=f32(1e-12))
    we, p_raster, valid = camera_we(camera, p_lens_world, -wi)
    return wi, torch.where(valid, we, 0.0), torch.where(valid, pdf, 0.0), p_raster, p_lens_world
