"""Textures: the thirteen kinds of pbrt_tpu/shade/textures.py, procedural
and mip-mapped image lookups (its counterpart).

A TextureTable is a packed SoA: each row has a kind, its parameters and,
for an image, an atlas slot. `evaluate` is a masked switch over the kinds
present, returning (..., 3). Scale and mix rows take one nested texture
level (ref1, ref2). Perlin noise hashes its integer lattice corners with
the stateless pcg hash (core/rng.py), negative corners wrapping to uint32
as the JAX package's casts wrap them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import rng
from ..core.types import f32

TEX_CONSTANT = 0   # v1
TEX_SCALE = 1      # ref1 · v1
TEX_MIX = 2        # lerp(scale, ref1, ref2)
TEX_BILERP = 3     # bilinear of four corner values over uv
TEX_UV = 4         # (u, v, 0)
TEX_CHECKER2D = 5  # v1 / v2 by the parity of floor(su·u) + floor(sv·v)
TEX_CHECKER3D = 6  # parity of the world point's cell
TEX_DOTS = 7       # polka dots
TEX_FBM = 8        # fbm noise
TEX_WRINKLED = 9   # turbulence
TEX_WINDY = 10     # windy waves
TEX_MARBLE = 11    # marble: sin warp of fbm through a colour ramp
TEX_IMAGE = 12     # mip-mapped image lookup

COLUMNS = ("kind", "v1", "v2", "v3", "v4", "su", "sv", "octaves", "omega", "scale",
           "ref1", "ref2", "atlas_slot", "atlas", "lvl_size", "lvl_off")
_INT_COLUMNS = ("kind", "octaves", "ref1", "ref2", "atlas_slot", "lvl_size", "lvl_off")


@dataclass
class TextureTable:
    kind: torch.Tensor        # (K,) int64
    v1: torch.Tensor          # (K, 3) primary value
    v2: torch.Tensor          # (K, 3) secondary value
    v3: torch.Tensor          # (K, 3) bilerp corner v01
    v4: torch.Tensor          # (K, 3) bilerp corner v11
    su: torch.Tensor          # (K,) u scale (marble: its scale)
    sv: torch.Tensor          # (K,) v scale
    octaves: torch.Tensor     # (K,) int64 noise octaves
    omega: torch.Tensor       # (K,) noise roughness
    scale: torch.Tensor       # (K,) mix amount / marble variation
    ref1: torch.Tensor        # (K,) int64 nested texture id
    ref2: torch.Tensor        # (K,) int64 nested texture id
    atlas_slot: torch.Tensor  # (K,) int64 image slot or -1
    # flat quad-packed mip chain (S, T, 12): entry (slot, lvl_off[l] +
    # y·sz_l + x) holds the texel's 2x2 wrap-around neighbourhood
    # [c00 c01 c10 c11], so one bilinear tap is one row gather
    atlas: torch.Tensor
    lvl_size: torch.Tensor    # (L,) int64
    lvl_off: torch.Tensor     # (L,) int64
    atlas_base: int = 1
    kinds_present: tuple = ()
    # kind, ref1, ref2 and octaves as host tuples: reachable() and the
    # noise loops read them without touching the device
    host: dict = None


def _quad_pack(level):
    right = np.roll(level, -1, axis=1)
    down = np.roll(level, -1, axis=0)
    diag = np.roll(down, -1, axis=1)
    return np.concatenate([level, right, down, diag], axis=-1).reshape(-1, 12)


def build_atlas_np(images):
    """Pad images to a common power-of-two square (nearest resample),
    box-filter mip pyramids, quad-pack each level into one flat chain.
    Returns (atlas, lvl_size, lvl_off, base); a 1-texel chain without
    images."""
    if not images:
        return (np.zeros((1, 1, 12), np.float32), np.ones((1,), np.int32),
                np.zeros((1,), np.int32), 1)
    hmax = max(int(2 ** np.ceil(np.log2(i.shape[0]))) for i in images)
    wmax = max(int(2 ** np.ceil(np.log2(i.shape[1]))) for i in images)
    size = max(hmax, wmax)
    levels = int(np.log2(size)) + 1
    lvl_size = np.array([size >> l for l in range(levels)], np.int32)
    lvl_off = np.concatenate([[0], np.cumsum(lvl_size.astype(np.int64) ** 2)[:-1]]).astype(np.int32)
    total = int(np.sum(lvl_size.astype(np.int64) ** 2))
    out = np.zeros((len(images), total, 12), np.float32)
    for s, img in enumerate(images):
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        h, w = img.shape[:2]
        yi = np.clip((np.arange(size) * h / size).astype(int), 0, h - 1)
        xi = np.clip((np.arange(size) * w / size).astype(int), 0, w - 1)
        cur = img[yi][:, xi].astype(np.float32)
        for l in range(levels):
            out[s, lvl_off[l]:lvl_off[l] + lvl_size[l] ** 2] = _quad_pack(cur)
            if l + 1 < levels:
                cur = 0.25 * (cur[0::2, 0::2] + cur[1::2, 0::2]
                              + cur[0::2, 1::2] + cur[1::2, 1::2])
    return out, lvl_size, lvl_off, size


def textures_from_numpy(arrs, device):
    """TextureTable from numpy: the COLUMNS and atlas_base, as the JAX
    package's TextureTable lays them out. A table that leaves one out is
    refused: its rows would lose a parameter without a word."""
    missing = [k for k in COLUMNS + ("atlas_base",) if k not in arrs]
    if missing:
        raise NotImplementedError(f"the texture table does not state {missing}")
    cols = {k: torch.as_tensor(np.asarray(arrs[k]), device=device).to(
        torch.int64 if k in _INT_COLUMNS else torch.float32) for k in COLUMNS}
    host = {k: tuple(np.asarray(arrs[k]).tolist()) for k in ("kind", "ref1", "ref2", "octaves")}
    return TextureTable(**cols, atlas_base=int(arrs["atlas_base"]),
                        kinds_present=tuple(sorted(set(host["kind"]))), host=host)


def reachable(tex: TextureTable, ids):
    """The kinds texture ids `ids` evaluate: (kinds of the ids, kinds of
    their scale and mix rows' nested ids)."""
    kind, r1, r2 = tex.host["kind"], tex.host["ref1"], tex.host["ref2"]
    ids = [i for i in ids if 0 <= i < len(kind)]
    nested = {r for i in ids if kind[i] in (TEX_SCALE, TEX_MIX) for r in (r1[i], r2[i])}
    return (tuple(sorted({kind[i] for i in ids})),
            tuple(sorted({kind[max(r, 0)] for r in nested})))


class TextureBuilder:
    """Texture rows as pbrt_tpu.shade.textures.TextureBuilder makes them;
    each method returns the new texture's id."""

    def __init__(self):
        self.rows = []
        self.images = []

    def _add(self, **kw):
        self.rows.append(kw)
        return len(self.rows) - 1

    def constant(self, value):
        return self._add(kind=TEX_CONSTANT, v1=value)

    def scale(self, tex_id, scale_value):
        return self._add(kind=TEX_SCALE, ref1=tex_id, v1=scale_value)

    def mix(self, tex1, tex2, amount):
        return self._add(kind=TEX_MIX, ref1=tex1, ref2=tex2, scale=amount)

    def bilerp(self, v00, v01, v10, v11):
        return self._add(kind=TEX_BILERP, v1=v00, v3=v01, v2=v10, v4=v11)

    def uv(self):
        return self._add(kind=TEX_UV)

    def checkerboard(self, v1, v2, su=1.0, sv=1.0, dims=2):
        return self._add(kind=TEX_CHECKER2D if dims == 2 else TEX_CHECKER3D,
                         v1=v1, v2=v2, su=su, sv=sv)

    def dots(self, inside, outside, su=1.0, sv=1.0):
        return self._add(kind=TEX_DOTS, v1=inside, v2=outside, su=su, sv=sv)

    def fbm(self, octaves=8, omega=0.5):
        return self._add(kind=TEX_FBM, octaves=octaves, omega=omega)

    def wrinkled(self, octaves=8, omega=0.5):
        return self._add(kind=TEX_WRINKLED, octaves=octaves, omega=omega)

    def windy(self):
        return self._add(kind=TEX_WINDY)

    def marble(self, octaves=8, omega=0.5, scale=1.0, variation=0.2):
        return self._add(kind=TEX_MARBLE, octaves=octaves, omega=omega, su=scale,
                         scale=variation)

    def image(self, img, su=1.0, sv=1.0):
        self.images.append(np.asarray(img, np.float32))
        return self._add(kind=TEX_IMAGE, atlas_slot=len(self.images) - 1, su=su, sv=sv)

    def build(self, device):
        k = len(self.rows)

        def col(key, default, shape=()):
            out = np.zeros((k,) + shape, np.float32)
            for i, r in enumerate(self.rows):
                v = r.get(key, default)
                out[i] = np.broadcast_to(np.asarray(v, np.float32), shape) if shape else v
            return out

        def icol(key, default):
            return np.array([r.get(key, default) for r in self.rows], np.int32)

        atlas, lvl_size, lvl_off, base = build_atlas_np(self.images)
        return textures_from_numpy(dict(
            kind=icol("kind", TEX_CONSTANT), v1=col("v1", 1.0, (3,)), v2=col("v2", 0.0, (3,)),
            v3=col("v3", 0.0, (3,)), v4=col("v4", 0.0, (3,)), su=col("su", 1.0),
            sv=col("sv", 1.0), octaves=icol("octaves", 8), omega=col("omega", 0.5),
            scale=col("scale", 1.0), ref1=icol("ref1", -1), ref2=icol("ref2", -1),
            atlas_slot=icol("atlas_slot", -1), atlas=atlas, lvl_size=lvl_size,
            lvl_off=lvl_off, atlas_base=base), device)


# ------------------------------------------------------------ noise

def _noise_grad(ix, iy, iz, dx, dy, dz):
    """Gradient term at a lattice corner; the corner's hash picks one of
    Perlin's twelve gradient directions (int64 keys wrap mod 2^32)."""
    h = rng.uniform_u32(ix, iy, iz) & 15
    u = torch.where(h < 8, dx, dy)
    v = torch.where(h < 4, dy, torch.where((h == 12) | (h == 14), dx, dz))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin(p):
    """Perlin gradient noise at points (..., 3) → (...,), about [-1, 1]."""
    pi = torch.floor(p)
    pf = p - pi
    ix, iy, iz = (pi[..., k].to(torch.int32).to(torch.int64) for k in range(3))
    dx, dy, dz = pf[..., 0], pf[..., 1], pf[..., 2]
    wx, wy, wz = _fade(dx), _fade(dy), _fade(dz)
    res = None
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                g = _noise_grad(ix + cx, iy + cy, iz + cz, dx - cx, dy - cy, dz - cz)
                weight = (wx if cx else (1 - wx)) * (wy if cy else (1 - wy)) \
                    * (wz if cz else (1 - wz))
                res = g * weight if res is None else res + g * weight
    return res


def _octaves(p, octaves, omega, fold, most=8):
    """Σ_i<octaves omega^i · fold(noise(1.99^i p)), at most 8 octaves; the
    loop stops at `most`, the most octaves any lane has (the terms past a
    lane's count add 0)."""
    total = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    lam, o = 1.0, 1.0
    for i in range(min(most, 8)):
        total = total + torch.where(i < octaves, o * fold(perlin(p * lam)), 0.0)
        lam = lam * 1.99
        o = o * omega
    return total


def fbm_noise(p, octaves, omega, most=8):
    return _octaves(p, octaves, omega, lambda n: n, most)


def turbulence(p, octaves, omega, most=8):
    return _octaves(p, octaves, omega, torch.abs, most)


# ------------------------------------------------------------ evaluate

def _level_bilinear(tex: TextureTable, slot, level, u, v):
    """Bilinear lookup at per-lane mip `level`: one quad-packed row gather."""
    sz = tex.lvl_size[level]
    off = tex.lvl_off[level]
    szf = sz.to(torch.float32)
    x = u * szf - 0.5
    y = v * szf - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0w = torch.remainder(x0.to(torch.int64), sz)
    y0w = torch.remainder(y0.to(torch.int64), sz)
    q = tex.atlas[slot, off + y0w * sz + x0w]
    c00, c01 = q[..., 0:3], q[..., 3:6]
    c10, c11 = q[..., 6:9], q[..., 9:12]
    return (1 - fy) * ((1 - fx) * c00 + fx * c01) + fy * ((1 - fx) * c10 + fx * c11)


def _image_lookup(tex: TextureTable, slot, uv, lod=None):
    """Bilinear at level 0 without a LOD, else trilinear between the two
    bracketing levels."""
    n_levels = tex.lvl_size.shape[0]
    slot = torch.clamp(slot, 0, tex.atlas.shape[0] - 1)
    u = torch.remainder(uv[..., 0], 1.0)
    v = torch.remainder(uv[..., 1], 1.0)
    if lod is None:
        return _level_bilinear(tex, slot, torch.zeros_like(slot), u, v)
    lod = torch.clamp(lod, 0.0, n_levels - 1 - 1e-4)
    l0f = torch.floor(lod)
    l0 = l0f.to(torch.int64)
    fl = (lod - l0f)[..., None]
    c0 = _level_bilinear(tex, slot, l0, u, v)
    c1 = _level_bilinear(tex, slot, torch.clamp(l0 + 1, max=n_levels - 1), u, v)
    return (1.0 - fl) * c0 + fl * c1


def _u32_of_cell(c):
    """A float cell index as a uint32 key: negatives saturate to 0 and
    values past 2^32 - 1 to 2^32 - 1, as the JAX package's float to
    uint32 cast does on the CPU."""
    return torch.clamp(c.to(torch.int64), 0, rng.M32)


_MARBLE_RAMP = ((0.25, 0.25, 0.35), (0.58, 0.58, 0.6), (0.9, 0.9, 0.91))


def _where(mask, val, out):
    return torch.where(mask[..., None], val, out)


def evaluate(tex: TextureTable, tid, uv, p, fp=None, ids=None, _kinds=None):
    """Texture ids `tid` (N,) at uv (N, 2) and world p (N, 3) → (N, 3).
    Scale and mix rows resolve one nested level. `fp` is the per-lane
    footprint in unscaled uv units (mip LOD). With `ids`, the texture ids
    that can occur among the lanes, only the kinds they reach are
    evaluated: the same values on those lanes, fewer launches."""
    if _kinds is None:
        _kinds = reachable(tex, ids) if ids is not None else \
            (tex.kinds_present, tex.kinds_present)
    kp = _kinds[0]
    t = torch.clamp(tid, min=0)
    kind = tex.kind[t]
    v1 = tex.v1[t]
    v2 = tex.v2[t]
    su = tex.su[t]
    sv = tex.sv[t]
    out = v1
    if TEX_UV in kp:
        out = _where(kind == TEX_UV, torch.stack([torch.remainder(uv[..., 0], 1.0),
                                                  torch.remainder(uv[..., 1], 1.0),
                                                  torch.zeros_like(uv[..., 0])], -1), out)
    if TEX_BILERP in kp:
        u = torch.remainder(uv[..., 0:1], 1.0)
        vv = torch.remainder(uv[..., 1:2], 1.0)
        bil = (1 - u) * (1 - vv) * v1 + (1 - u) * vv * tex.v3[t] + u * (1 - vv) * v2 \
            + u * vv * tex.v4[t]
        out = _where(kind == TEX_BILERP, bil, out)
    if TEX_CHECKER2D in kp:
        par = torch.remainder((torch.floor(uv[..., 0] * su) + torch.floor(uv[..., 1] * sv))
                              .to(torch.int32), 2)
        out = _where(kind == TEX_CHECKER2D, _where(par == 0, v1, v2), out)
    if TEX_CHECKER3D in kp:
        par = torch.remainder((torch.floor(p[..., 0]) + torch.floor(p[..., 1])
                               + torch.floor(p[..., 2])).to(torch.int32), 2)
        out = _where(kind == TEX_CHECKER3D, _where(par == 0, v1, v2), out)
    if TEX_DOTS in kp:
        us, vs = uv[..., 0] * su, uv[..., 1] * sv
        c0, c1 = torch.floor(us + 0.5), torch.floor(vs + 0.5)
        k0, k1 = _u32_of_cell(c0), _u32_of_cell(c1)
        cu = rng.uniform_float(k0, k1, 1)
        cv = rng.uniform_float(k0, k1, 2)
        has_dot = rng.uniform_float(k0, k1, 0) < 0.5
        d2 = (us - (c0 + (cu - 0.5) * 0.5)) ** 2 + (vs - (c1 + (cv - 0.5) * 0.5)) ** 2
        inside = has_dot & (d2 < f32(0.35 * 0.35))
        out = _where(kind == TEX_DOTS, _where(inside, v1, v2), out)
    if {TEX_FBM, TEX_WRINKLED, TEX_WINDY, TEX_MARBLE} & set(kp):
        octv = tex.octaves[t]
        om = tex.omega[t]
        most = max(tex.host["octaves"])
        if TEX_FBM in kp:
            n = fbm_noise(p, octv, om, most)[..., None]
            out = _where(kind == TEX_FBM, v1 * (0.5 + 0.5 * n), out)
        if TEX_WRINKLED in kp:
            out = _where(kind == TEX_WRINKLED, v1 * turbulence(p, octv, om, most)[..., None],
                         out)
        if TEX_WINDY in kp:
            strength = fbm_noise(0.1 * p, torch.full_like(octv, 3), torch.full_like(om, 0.5),
                                 3).abs()
            height = fbm_noise(p, torch.full_like(octv, 6), torch.full_like(om, 0.5), 6)
            out = _where(kind == TEX_WINDY, v1 * (strength * height)[..., None], out)
        if TEX_MARBLE in kp:
            # p · scale per lane; the JAX package broadcasts (N, 3) against
            # (N,) here, which is right for one lane only
            sc = su
            var = tex.scale[t]
            mt = 0.5 + 0.5 * torch.sin(p[..., 1] * sc * 4.0
                                       + var * fbm_noise(p * sc[..., None], octv, om, most)
                                       * 5.0)
            dark, mid, light = (torch.tensor(c, dtype=torch.float32, device=p.device)
                                for c in _MARBLE_RAMP)
            col = _where(mt < 0.5, dark + (mt * 2.0)[..., None] * (mid - dark),
                         mid + ((mt - 0.5) * 2.0)[..., None] * (light - mid))
            out = _where(kind == TEX_MARBLE, col, out)
    if TEX_IMAGE in kp:
        suv = torch.stack([uv[..., 0] * su, uv[..., 1] * sv], -1)
        lod = None
        if fp is not None:
            fp_tex = fp * torch.maximum(su, sv) * tex.atlas_base
            lod = torch.log2(torch.clamp(fp_tex, min=1.0))
        out = _where(kind == TEX_IMAGE, _image_lookup(tex, tex.atlas_slot[t], suv, lod=lod), out)
    if len(_kinds) > 1 and (TEX_SCALE in kp or TEX_MIX in kp):
        nested = (_kinds[1],)
        r1 = evaluate(tex, tex.ref1[t], uv, p, fp=fp, _kinds=nested)
        if TEX_SCALE in kp:
            out = _where(kind == TEX_SCALE, r1 * v1, out)
        if TEX_MIX in kp:
            r2 = evaluate(tex, tex.ref2[t], uv, p, fp=fp, _kinds=nested)
            amt = tex.scale[t][..., None]
            out = _where(kind == TEX_MIX, (1.0 - amt) * r1 + amt * r2, out)
    return out


def apply_tex(tex: TextureTable, tid, uv, p, base, fp=None, ids=None):
    """base where tid < 0, the texture's value otherwise; `ids` as in
    evaluate."""
    if tex is None:
        return base
    return torch.where((tid >= 0)[..., None], evaluate(tex, tid, uv, p, fp=fp, ids=ids), base)
