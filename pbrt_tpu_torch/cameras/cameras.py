"""Perspective camera: ray generation and the pixel ray cone
(counterpart of pbrt_tpu/cameras/cameras.py, perspective part)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import transform as tf
from ..core import vecmath as vm
from ..core.types import f32


class PerspectiveCamera(NamedTuple):
    camera_to_world: tf.Transform
    raster_to_camera: tf.Transform
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    area: float                 # film area at z=1 in camera space
    resolution: tuple           # (h, w)


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
    """camera_to_world: (4, 4) host matrix."""
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


def cone_start(camera: PerspectiveCamera):
    """(width0, spread) of the pixel ray cone, float32 scalars."""
    h, w = camera.resolution
    x0, x1, y0, y1 = _screen_window(h, w)
    area = np.float32(camera.area)
    tan_half = np.sqrt(area / np.float32(abs((x1 - x0) * (y1 - y0))))
    return 0.0, float(np.float32(np.float32(y1 - y0) * tan_half / np.float32(h)))


def generate_rays_weighted(camera: PerspectiveCamera, pfilm, u_lens, u_time):
    """Batched ray generation. Returns (o, d, time, weight)."""
    time = camera.shutter_open + u_time * (camera.shutter_close - camera.shutter_open)
    p_raster = torch.cat([pfilm, torch.zeros_like(pfilm[..., :1])], -1)
    p_cam = camera.raster_to_camera.apply_point(p_raster)
    if camera.lens_radius > 0.0:
        raise NotImplementedError("thin-lens depth of field is not ported yet")
    o_cam = torch.zeros_like(p_cam)
    d_cam = vm.normalize(p_cam)
    o = camera.camera_to_world.apply_point(o_cam)
    d = vm.normalize(camera.camera_to_world.apply_vector(d_cam))
    return o, d, time, torch.ones(pfilm.shape[:-1], dtype=torch.float32,
                                  device=pfilm.device)
