"""Image files (counterpart of pbrt_tpu/film/io.py): PNG (zlib), PFM, NPY
and OpenEXR (uncompressed float32 scanlines), with no library beyond
numpy. Each writer takes an (H, W, 3) image as a tensor on any device or
as a numpy array; the bytes are made on the host. Readers return float32
numpy arrays."""
from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..core import spectrum


def _host(image, dtype=None):
    """The image as a numpy array on the host."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    return np.asarray(image, dtype)


def write_png(path, image, gamma=True):
    """image: (H, W, 3) linear radiance (sRGB-encoded when `gamma`), or uint8."""
    img = _host(image)
    if img.dtype != np.uint8:
        if gamma:
            img = spectrum.gamma_correct(torch.as_tensor(img, dtype=torch.float32)).numpy()
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(ft, line, prev, nch):
    """One PNG scanline with its filter (0–4) undone."""
    if ft == 0:
        return line
    if ft == 2:
        return (line + prev) & 0xFF
    rec = np.zeros_like(line)
    for x in range(len(line)):
        a = rec[x - nch] if x >= nch else 0
        b = prev[x]
        c = prev[x - nch] if x >= nch else 0
        if ft == 1:
            pred = a
        elif ft == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        rec[x] = (line[x] + pred) & 0xFF
    return rec


def read_png(path):
    """8-bit gray, gray+alpha, RGB or RGBA PNG without interlace →
    linear (sRGB-decoded) float32 (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a png")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _, _, interlace = ihdr
    if depth != 8 or interlace != 0 or color not in (0, 2, 4, 6):
        raise ValueError(f"{path}: unsupported png variant")
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        p = y * (stride + 1)
        line = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(np.int32)
        out[y] = _unfilter(raw[p], line, prev, nch).astype(np.uint8)
        prev = out[y].astype(np.int32)
    img = out.reshape(h, w, nch).astype(np.float32) / 255.0
    img = np.repeat(img[..., :1], 3, axis=-1) if nch < 3 else img[..., :3]
    return spectrum.inverse_gamma_correct(torch.as_tensor(np.ascontiguousarray(img))).numpy()


def write_pfm(path, image):
    """PFM: float32, rows bottom-up, little-endian (scale -1)."""
    img = _host(image, np.float32)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        f.write(np.flipud(img).tobytes())


def read_pfm(path):
    with open(path, "rb") as f:
        header = f.readline().strip()
        w, h = (int(x) for x in f.readline().split()[:2])
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if header == b"PF" else data.reshape(h, w)
    return np.flipud(img).astype(np.float32)


def write_npy(path, image):
    np.save(path, _host(image, np.float32))


def write_exr(path, image):
    """OpenEXR 2.0: uncompressed scanlines of float32 B, G, R."""
    img = _host(image, np.float32)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)

    def attr(name, typ, data):
        return name.encode() + b"\x00" + typ.encode() + b"\x00" \
            + struct.pack("<I", len(data)) + data

    window = struct.pack("<4i", 0, 0, w - 1, h - 1)
    # FLOAT channels, sampling 1, 1
    chans = b"".join(c + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
                     for c in (b"B", b"G", b"R")) + b"\x00"
    header = (attr("channels", "chlist", chans)
              + attr("compression", "compression", b"\x00")
              + attr("dataWindow", "box2i", window)
              + attr("displayWindow", "box2i", window)
              + attr("lineOrder", "lineOrder", b"\x00")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0.0, 0.0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0)) + b"\x00")
    magic = struct.pack("<II", 20000630, 2)
    data_start = len(magic) + len(header) + 8 * h
    scan_size = 8 + 3 * w * 4
    offsets = (data_start + scan_size * np.arange(h, dtype=np.uint64)).astype("<u8")
    lines = np.zeros(h, np.dtype([("y", "<i4"), ("n", "<u4"), ("bgr", "<f4", (3, w))]))
    lines["y"], lines["n"] = np.arange(h), 3 * w * 4
    lines["bgr"] = img[:, :, ::-1].transpose(0, 2, 1)
    with open(path, "wb") as f:
        f.write(magic + header + offsets.tobytes() + lines.tobytes())


def read_exr(path):
    """Reader for what write_exr writes (uncompressed float32 RGB)."""
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<I", data[:4])[0] != 20000630:
        raise ValueError(f"{path}: not an EXR")
    pos, attrs = 8, {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\x00", pos)
        typ = data[pos:e].decode()
        pos = e + 1
        (sz,) = struct.unpack("<I", data[pos:pos + 4])
        attrs[name] = (typ, data[pos + 4:pos + 4 + sz])
        pos += 4 + sz
    pos += 1
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = xmax - xmin + 1, ymax - ymin + 1
    pos += 8 * h                    # the offset table
    img = np.zeros((h, w, 3), np.float32)
    for _ in range(h):
        yy, sz = struct.unpack("<iI", data[pos:pos + 8])
        img[yy - ymin] = np.frombuffer(data[pos + 8:pos + 8 + sz], "<f4").reshape(3, w)[::-1].T
        pos += 8 + sz
    return img


def write_image(path, image):
    """Write by extension: .png, .exr, .pfm or .npy."""
    p = str(path)
    for ext, fn in ((".png", write_png), (".exr", write_exr), (".pfm", write_pfm),
                    (".npy", write_npy)):
        if p.endswith(ext):
            return fn(p, image)
    raise ValueError(f"unsupported image extension: {p}")


def read_image(path):
    """Read by extension: .png, .exr, .pfm or .npy."""
    p = str(path)
    if p.endswith(".npy"):
        return np.load(p).astype(np.float32)
    for ext, fn in ((".png", read_png), (".exr", read_exr), (".pfm", read_pfm)):
        if p.endswith(ext):
            return fn(p)
    raise ValueError(f"unsupported image extension: {p}")
