"""Image textures: the quad-packed mip atlas and its trilinear lookup
(counterpart of TEX_IMAGE in pbrt_tpu/shade/textures.py)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

TEX_IMAGE = 12
PORTED_KINDS = (TEX_IMAGE,)


@dataclass
class TextureTable:
    kind: torch.Tensor        # (K,) int64
    su: torch.Tensor          # (K,) u scale
    sv: torch.Tensor          # (K,) v scale
    atlas_slot: torch.Tensor  # (K,) int64
    # flat quad-packed mip chain (S, T, 12): entry (slot, lvl_off[l] +
    # y·sz_l + x) holds the texel's 2x2 wrap-around neighbourhood
    # [c00 c01 c10 c11], so one bilinear tap is one row gather
    atlas: torch.Tensor
    lvl_size: torch.Tensor    # (L,) int64
    lvl_off: torch.Tensor     # (L,) int64
    atlas_base: int = 1


def _quad_pack(level):
    right = np.roll(level, -1, axis=1)
    down = np.roll(level, -1, axis=0)
    diag = np.roll(down, -1, axis=1)
    return np.concatenate([level, right, down, diag], axis=-1).reshape(-1, 12)


def build_atlas_np(images):
    """Pad images to a common power-of-two square (nearest resample),
    box-filter mip pyramids, quad-pack each level into one flat chain.
    Returns (atlas, lvl_size, lvl_off, base)."""
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
    """TextureTable from numpy columns kind, su, sv, atlas_slot, atlas,
    lvl_size, lvl_off, atlas_base."""
    kind = np.asarray(arrs["kind"], np.int64)
    bad = sorted(set(kind.tolist()) - set(PORTED_KINDS))
    if bad:
        raise NotImplementedError(f"texture kinds {bad} are not ported yet")
    t = lambda a, dt=torch.float32: torch.as_tensor(np.asarray(a), device=device).to(dt)  # noqa: E731
    return TextureTable(kind=t(kind, torch.int64), su=t(arrs["su"]), sv=t(arrs["sv"]),
                        atlas_slot=t(arrs["atlas_slot"], torch.int64),
                        atlas=t(arrs["atlas"]), lvl_size=t(arrs["lvl_size"], torch.int64),
                        lvl_off=t(arrs["lvl_off"], torch.int64),
                        atlas_base=int(arrs["atlas_base"]))


def build_image_textures(images_su_sv, device):
    """[(image, su, sv)] → TextureTable of image textures."""
    atlas, lvl_size, lvl_off, base = build_atlas_np(
        [np.asarray(i, np.float32) for i, _, _ in images_su_sv])
    n = len(images_su_sv)
    return textures_from_numpy(dict(
        kind=[TEX_IMAGE] * n, su=[s for _, s, _ in images_su_sv],
        sv=[v for _, _, v in images_su_sv], atlas_slot=list(range(n)), atlas=atlas,
        lvl_size=lvl_size, lvl_off=lvl_off, atlas_base=base), device)


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


def evaluate(tex: TextureTable, tid, uv, p, fp=None):
    """Texture ids `tid` (N,) at uv (N, 2) → (N, 3); `fp` is the per-lane
    footprint in unscaled uv units (mip LOD)."""
    t = torch.clamp(tid, min=0)
    su = tex.su[t]
    sv = tex.sv[t]
    suv = torch.stack([uv[..., 0] * su, uv[..., 1] * sv], -1)
    lod = None
    if fp is not None:
        fp_tex = fp * torch.maximum(su, sv) * tex.atlas_base
        lod = torch.log2(torch.clamp(fp_tex, min=1.0))
    return _image_lookup(tex, tex.atlas_slot[t], suv, lod=lod)


def apply_tex(tex: TextureTable, tid, uv, p, base, fp=None):
    """base where tid < 0, the texture's value otherwise."""
    if tex is None:
        return base
    return torch.where((tid >= 0)[..., None], evaluate(tex, tid, uv, p, fp=fp), base)
