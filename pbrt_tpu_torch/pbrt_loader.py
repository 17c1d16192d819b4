"""A subset of the PBRT-v3 `.pbrt` scene format on top of
api.SceneBuilder (counterpart of pbrt_tpu/pbrt_loader.py, with its
directives, defaults and quirks).

directives: LookAt, Camera (its fov; always perspective), Film, Sampler,
  Integrator, WorldBegin/End, AttributeBegin/End, Translate, Scale,
  Rotate, Transform, ConcatTransform, Material, MakeNamedMaterial,
  NamedMaterial, Shape (trianglemesh, plymesh, sphere, disk),
  AreaLightSource (diffuse), LightSource (point, distant, spot,
  infinite). Include and every other directive (Texture among them) are
  skipped with their parameters.

load_pbrt returns (scene, camera, render options). The scene's triangles
are traced through the cluster set (bvh=True): on the card, the CUDA
kernels."""
from __future__ import annotations

import os
import re

import numpy as np

from . import resolve_device
from .api import SceneBuilder
from .cameras import make_perspective
from .core import transform as tf
from .geom.meshio import read_ply
from .shade import materials as matmod

SAMPLERS = {"lowdiscrepancy": "zerotwo", "02sequence": "zerotwo", "halton": "halton",
            "sobol": "sobol", "random": "random", "stratified": "stratified",
            "maxmindist": "maxmin"}
_FLOAT_TYPES = ("float", "rgb", "color", "point", "point3", "normal", "vector",
                "blackbody", "spectrum")


def _tokenize(text):
    """Quoted strings, brackets and bare words, comments dropped."""
    return re.findall(r'"[^"]*"|\[|\]|[^\s\[\]]+', re.sub(r"#.*", "", text))


def _parse_params(toks, i):
    """`"type name" value` or `"type name" [values...]` pairs from toks[i]
    up to the next directive. Returns ({name: (type, [values])}, next i)."""
    params = {}
    while i < len(toks) and toks[i].startswith('"'):
        parts = toks[i][1:-1].split()
        i += 1
        ptype, pname = (parts[0], parts[1]) if len(parts) == 2 else ("string", parts[0])
        vals = []
        if i < len(toks) and toks[i] == "[":
            i += 1
            while toks[i] != "]":
                vals.append(toks[i])
                i += 1
            i += 1
        elif i < len(toks):
            vals.append(toks[i])
            i += 1
        if ptype in _FLOAT_TYPES:
            params[pname] = (ptype, [float(v.strip('"')) for v in vals
                                     if not v.startswith('"')]
                             or [float(v.strip('"')) for v in vals])
        elif ptype == "integer":
            params[pname] = (ptype, [int(float(v)) for v in vals])
        elif ptype == "bool":
            params[pname] = (ptype, [v.strip('"') == "true" for v in vals])
        else:
            params[pname] = (ptype, [v.strip('"') for v in vals])
    return params, i


def _get(params, name, default=None):
    """A parameter's value: the one number or string, or the list."""
    if name in params:
        v = params[name][1]
        return v[0] if len(v) == 1 else v
    return default


def _material(b, mtype, params):
    """A material row of `mtype` (matte where the type is unknown). metal
    takes only its roughness (eta and k stay the builder's defaults)."""
    g = lambda name, default: _get(params, name, default)  # noqa: E731
    if mtype == "plastic":
        return b.plastic(kd=g("Kd", (0.25,) * 3), ks=g("Ks", (0.25,) * 3),
                         roughness=g("roughness", 0.1))
    if mtype == "glass":
        return b.glass(kr=g("Kr", 1.0), kt=g("Kt", 1.0), eta=g("eta", g("index", 1.5)),
                       roughness=g("roughness", 0.0))
    if mtype == "mirror":
        return b.mirror(kr=g("Kr", 0.9))
    if mtype == "metal":
        return b.metal(roughness=g("roughness", 0.01))
    if mtype == "substrate":
        return b.substrate(kd=g("Kd", (0.5,) * 3), ks=g("Ks", (0.5,) * 3),
                           roughness=g("uroughness", 0.1))
    if mtype == "uber":
        return b.uber(kd=g("Kd", 0.25), ks=g("Ks", 0.25), kr=g("Kr", 0.0),
                      roughness=g("roughness", 0.1))
    if mtype == "translucent":
        return b.translucent(kd=g("Kd", 0.25))
    if mtype == "disney":
        return b.material(kind=matmod.MAT_DISNEY, kd=g("color", (0.5,) * 3),
                          aux=(g("metallic", 0.0), g("speculartint", 0.0), g("sheen", 0.0),
                               g("sheentint", 0.5), g("clearcoat", 0.0),
                               g("clearcoatgloss", 1.0), g("roughness", 0.5), 0.0))
    if mtype == "matte":
        return b.matte(kd=g("Kd", (0.5, 0.5, 0.5)), sigma=g("sigma", 0.0))
    return b.matte(kd=(0.5, 0.5, 0.5))


def load_pbrt(path, device=None):
    """Parse the scene file at `path` and build its scene on `device` (cuda
    unless told otherwise). Returns (scene, camera, options): options has
    "integrator", "max_depth", "sampler" (a SamplerConfig kind) and "spp"."""
    device = resolve_device(device)
    with open(path) as f:
        toks = _tokenize(f.read())
    b = SceneBuilder()
    ctm = np.eye(4)                    # float64, as the points are transformed
    material = area_light = default_mat = None
    stack, named = [], {}
    look = (np.array([0, 0, 5.0]), np.zeros(3), np.array([0, 1.0, 0]))
    fov, film_res = 60.0, (256, 256)
    options = {"integrator": "path", "max_depth": 5, "sampler": "zerotwo", "spp": 16}

    def xf_points(v):
        v = np.asarray(v, np.float64).reshape(-1, 3)
        return (v @ ctm[:3, :3].T + ctm[:3, 3]).astype(np.float32)

    def numbers(i, n):
        return [float(toks[i + k]) for k in range(n)], i + n

    i = 0
    while i < len(toks):
        t = toks[i]
        i += 1
        if t == "LookAt":
            v, i = numbers(i, 9)
            look = (np.array(v[0:3]), np.array(v[3:6]), np.array(v[6:9]))
        elif t == "Camera":
            params, i = _parse_params(toks, i + 1)
            fov = _get(params, "fov", 60.0)
        elif t == "Film":
            params, i = _parse_params(toks, i + 1)
            film_res = (int(_get(params, "yresolution", 256)),
                        int(_get(params, "xresolution", 256)))
        elif t == "Sampler":
            stype = toks[i][1:-1]
            params, i = _parse_params(toks, i + 1)
            options["sampler"] = SAMPLERS.get(stype, "zerotwo")
            options["spp"] = int(_get(params, "pixelsamples", 16))
        elif t == "Integrator":
            options["integrator"] = toks[i][1:-1]
            params, i = _parse_params(toks, i + 1)
            options["max_depth"] = int(_get(params, "maxdepth", 5))
        elif t == "WorldBegin":
            ctm = np.eye(4)
        elif t == "AttributeBegin":
            stack.append((ctm.copy(), material, area_light))
        elif t == "AttributeEnd":
            ctm, material, area_light = stack.pop()
        elif t == "Translate":
            v, i = numbers(i, 3)
            m = np.eye(4)
            m[:3, 3] = v
            ctm = ctm @ m
        elif t == "Scale":
            v, i = numbers(i, 3)
            ctm = ctm @ np.diag(v + [1.0])
        elif t == "Rotate":
            (ang, x, y, z), i = numbers(i, 4)
            ctm = ctm @ np.asarray(tf.rotate_np(ang, [x, y, z]), np.float64)
        elif t in ("Transform", "ConcatTransform"):
            if toks[i] != "[":
                raise ValueError(f"{path}: {t} expects [ 16 numbers ]")
            m = np.asarray([float(v) for v in toks[i + 1:i + 17]], np.float64).reshape(4, 4).T
            i += 18
            ctm = m if t == "Transform" else ctm @ m     # column-major in the file
        elif t == "Material":
            mtype = toks[i][1:-1]
            params, i = _parse_params(toks, i + 1)
            material = _material(b, mtype, params)
        elif t == "MakeNamedMaterial":
            name = toks[i][1:-1]
            params, i = _parse_params(toks, i + 1)
            named[name] = _material(b, _get(params, "type", "matte"), params)
        elif t == "NamedMaterial":
            material = named.get(toks[i][1:-1])       # unknown: the default matte
            i += 1
        elif t == "AreaLightSource":
            params, i = _parse_params(toks, i + 1)
            area_light = np.asarray(_get(params, "L", (1.0, 1.0, 1.0)), np.float32)
        elif t == "LightSource":
            ltype = toks[i][1:-1]
            params, i = _parse_params(toks, i + 1)
            if ltype == "point":
                b.point_light(xf_points(_get(params, "from", (0, 0, 0)))[0],
                              _get(params, "I", (1.0, 1.0, 1.0)))
            elif ltype == "distant":
                fr = np.asarray(_get(params, "from", (0, 0, 0)), np.float64)
                to = np.asarray(_get(params, "to", (0, 0, 1)), np.float64)
                b.distant_light(fr - to, _get(params, "L", (1.0, 1.0, 1.0)))
            elif ltype == "spot":
                fr = xf_points(_get(params, "from", (0, 0, 0)))[0]
                to = xf_points(_get(params, "to", (0, 0, 1)))[0]
                b.spot_light(fr, to - fr, _get(params, "I", (1.0, 1.0, 1.0)),
                             cone_deg=_get(params, "coneangle", 30.0),
                             falloff_deg=_get(params, "conedeltaangle", 5.0))
            elif ltype == "infinite":
                b.infinite_light(radiance=_get(params, "L", 1.0))
        elif t == "Shape":
            stype = toks[i][1:-1]
            params, i = _parse_params(toks, i + 1)
            if material is None:
                if default_mat is None:
                    default_mat = b.matte(kd=(0.5, 0.5, 0.5))
                mat = default_mat
            else:
                mat = material
            if stype in ("trianglemesh", "plymesh"):
                if stype == "trianglemesh":
                    pts = xf_points(params["P"][1])
                    idx = np.asarray(params["indices"][1], np.int32).reshape(-1, 3)
                    uv = _get(params, "uv", _get(params, "st"))
                    extra = dict(uvs=None if uv is None
                                 else np.asarray(uv, np.float32).reshape(-1, 2))
                else:
                    mesh = read_ply(os.path.join(os.path.dirname(path),
                                                 _get(params, "filename")))
                    pts, idx = xf_points(mesh["vertices"]), mesh["indices"]
                    extra = dict(normals=mesh.get("normals"))
                if area_light is not None:
                    b.area_light_mesh(pts, idx, area_light, material=mat)
                else:
                    b.add_mesh(pts, idx, mat, **extra)
            elif stype == "sphere":
                r = float(_get(params, "radius", 1.0))
                center = (ctm @ np.array([0, 0, 0, 1.0]))[:3]
                if area_light is not None:
                    b.area_light_sphere(center, r, area_light, material=mat)
                else:
                    b.add_sphere(center, r, mat)
            elif stype == "disk":
                b.add_disk(np.asarray(ctm, np.float32), float(_get(params, "radius", 1.0)),
                           mat, height=float(_get(params, "height", 0.0)))
        elif t == "Include":
            i += 1
        elif t != "WorldEnd" and i < len(toks) and toks[i].startswith('"'):
            _, i = _parse_params(toks, i + 1)          # any other directive
    scene = b.build(bvh=True, device=device)
    c2w = tf.look_at_np(*(np.asarray(a, np.float32) for a in look))
    return scene, make_perspective(c2w, fov, film_res, device), options
