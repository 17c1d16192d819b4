"""Scene data carried across from numpy.

`scene_from_numpy` takes a scene as plain numpy arrays — the JAX
package's Scene, QuadricSoA, ClusterSet, MaterialTable, TextureTable,
LightTable, SpatialLightDistribution and MediumTable fields flattened to
dicts by the caller — and returns the port's Scene,
so both packages can render the very same scene. `camera_from_numpy`
does the same for a perspective camera, and `bdpt_config`, `sppm_config`
and `mlt_config` for the integrators' configs. Nothing here imports the
JAX package."""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .cameras.cameras import PerspectiveCamera
from .core import transform as tf
from .core.samplers import SamplerConfig
from .geom import cluster as clmod
from .geom.scene import Scene
from .geom.types import quadrics_from_numpy, triangles_from_numpy
from .integrate.bdpt import BDPTConfig
from .integrate.mlt import MLTConfig
from .integrate.sppm import SPPMConfig
from .lights.distrib import spatial_from_numpy
from .lights.lights import lights_from_numpy
from .shade.materials import materials_from_numpy
from .shade.media import media_from_numpy
from .shade.textures import textures_from_numpy


def _clusters(c, device):
    """The JAX ClusterSet's fields → the port's ClusterSet. Slab bounds
    come from the coverage feature table: plane 2·ax (lo) and 2·ax+1 (hi)
    carry the bound in feature row ax."""
    cov = np.asarray(c["cov_mxu"], np.float32)
    bounds = np.zeros((6, cov.shape[2]), np.float32)
    for ax in range(3):
        bounds[2 * ax] = cov[ax, 2 * ax]
        bounds[2 * ax + 1] = cov[ax, 2 * ax + 1]
    return clmod.cluster_set_from_numpy(dict(
        packed=c["packed"], bounds=bounds, c_tri_id=np.asarray(c["c_tri_id"], np.int64),
        world_min=c["world_min"], world_max=c["world_max"]), device)


def scene_from_numpy(tree, device=None, tile=clmod.TILE):
    """tree: dict with "tri", "quad" (or None when "quad_count" is 0),
    "clusters" (or None), "materials", "lights", "textures" (or None),
    "light_distrib" (or None) and "media" (or None) sub-dicts of numpy
    arrays, plus "world_center", "world_radius", "quad_count" and
    "instance_count". Instances are not ported: a scene with any is
    refused, and so is a tree that does not state both counts and its
    media, or that states quadrics and leaves out their arrays (they would
    go missing without a word)."""
    device = resolve_device(device)
    t = tree["tri"]
    missing = [k for k in ("quad_count", "instance_count", "media") if k not in tree]
    if missing:
        raise NotImplementedError(f"the scene tree does not state {missing}: a scene "
                                  "must show its quadrics, its media (None or arrays) "
                                  "and that it has no instances")
    if int(tree["instance_count"]):
        raise NotImplementedError("instances are not ported yet")
    quad = tree.get("quad")
    if int(tree["quad_count"]) != (0 if quad is None else len(quad["kind"])):
        raise NotImplementedError(f"the tree states {int(tree['quad_count'])} quadrics "
                                  "and carries the arrays of "
                                  f"{0 if quad is None else len(quad['kind'])}")
    return Scene(
        tri=triangles_from_numpy(t["positions"], t["indices"], t["normals"], t["uvs"],
                                 t["has_normals"], t["material_id"], t["light_id"], device),
        quad=quadrics_from_numpy(quad, device),
        clusters=_clusters(tree["clusters"], device) if tree.get("clusters") else None,
        materials=materials_from_numpy(tree["materials"], device),
        lights=lights_from_numpy(tree["lights"], device),
        textures=(textures_from_numpy(tree["textures"], device)
                  if tree.get("textures") else None),
        light_distrib=spatial_from_numpy(tree.get("light_distrib"), device),
        world_center=torch.as_tensor(np.asarray(tree["world_center"], np.float32),
                                     device=device),
        world_radius=float(np.float32(tree["world_radius"])),
        tile=tile, media=media_from_numpy(tree["media"], device))


def camera_from_numpy(cam, device=None):
    """cam: dict of a perspective camera's fields; each transform is a
    pair (m, m_inv) of (4, 4) arrays, used as given."""
    device = resolve_device(device)

    def xf(pair):
        m, m_inv = pair
        return tf.Transform(torch.tensor(np.array(m, np.float32), device=device),
                            torch.tensor(np.array(m_inv, np.float32), device=device))

    f = lambda k: float(np.float32(cam[k]))  # noqa: E731
    return PerspectiveCamera(
        camera_to_world=xf(cam["camera_to_world"]),
        raster_to_camera=xf(cam["raster_to_camera"]),
        lens_radius=f("lens_radius"), focal_distance=f("focal_distance"),
        shutter_open=f("shutter_open"), shutter_close=f("shutter_close"),
        area=f("area"), resolution=tuple(int(x) for x in cam["resolution"]))


def params_from_numpy(tree, device=None):
    """Scene parameters as numpy (the JAX package's
    diff.inverse.default_params with each leaf passed through np.asarray:
    {"materials": {kd, ks, kr, kt, roughness, eta}, "lights": {emit}},
    or any part of it) → the same dict of float32 tensors on `device`, the
    form pbrt_tpu_torch.diff.inverse.apply_params takes."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.array(tree, np.float32), device=device)


def params_to_numpy(params):
    """The port's parameter dict → the same dict of float32 numpy arrays."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    return params.detach().cpu().numpy().astype(np.float32)


def _config(cfg, cls):
    """A config NamedTuple of the JAX package → the port's `cls`, field
    for field (its sampler too). A config whose fields differ is refused."""
    fields = dict(cfg._asdict())
    if set(fields) != set(cls._fields):
        raise ValueError(f"{type(cfg).__name__} has fields {sorted(fields)}; "
                         f"{cls.__name__} has {sorted(cls._fields)}")
    if "sampler" in fields:
        fields["sampler"] = SamplerConfig(**fields["sampler"]._asdict())
    return cls(**fields)


def bdpt_config(cfg):
    """The JAX package's integrate.bdpt.BDPTConfig → the port's."""
    return _config(cfg, BDPTConfig)


def sppm_config(cfg):
    """The JAX package's integrate.sppm.SPPMConfig → the port's."""
    return _config(cfg, SPPMConfig)


def mlt_config(cfg):
    """The JAX package's integrate.mlt.MLTConfig → the port's."""
    return _config(cfg, MLTConfig)
