"""Misc IO and geometry helpers (the port's copy of
``nvsf_tpu/lib/tools.py``, which rebuilds ``nvsf/lib/tools.py``), and the
image writers of the eval and test artifacts: 8-bit PNGs (``write_png``)
and animated GIFs (``write_gif``), standard library only, so that the port
needs no image package.
"""

from __future__ import annotations

import csv
import json
import os
import struct
import zlib
from types import SimpleNamespace

import numpy as np

from nvsf_torch.lib.pose import (  # noqa: F401  (re-exported)
    bbox_corners, quaternion_to_matrix)


def read_json(path):
    with open(path) as f:
        return json.load(f)


def write_json(path, data):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, default=float)


def read_csv(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def write_csv(path, rows):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)


def read_yaml(path):
    """Minimal yaml reader of flat ``key: value`` maps (values as
    strings, ``#`` comments dropped); PyYAML is not a dependency."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if ":" in line:
                k, v = line.split(":", 1)
                out[k.strip()] = v.strip()
    return out


def dict_to_cls(**kwargs):
    """dict -> attribute object, nested dicts too (``tools.py:162-165``)."""
    return SimpleNamespace(**{
        k: (dict_to_cls(**v) if isinstance(v, dict) else v)
        for k, v in kwargs.items()})


def check_in_hull(points, hull_vertices):
    """Convex-hull membership (``tools.py:138-160``); see lib/masks.py."""
    from nvsf_torch.lib.masks import check_in_hull as _cih
    return _cih(np.asarray(points), np.asarray(hull_vertices))


def filter_outliers(pc, nb_neighbors=20, std_ratio=2.0):
    """Statistical outlier filter (``tools.py:84-115``)."""
    from nvsf_torch.lib.pointcloud import statistical_outlier_removal
    return statistical_outlier_removal(np.asarray(pc), nb_neighbors,
                                       std_ratio)


def write_pcd(path, points, intensities=None):
    """ASCII .pcd writer (replaces the open3d writer, ``tools.py:230-249``)."""
    pts = np.asarray(points)
    n = len(pts)
    has_i = intensities is not None
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        fields = "x y z intensity" if has_i else "x y z"
        nf = 4 if has_i else 3
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        f.write(f"SIZE {' '.join(['4'] * nf)}\n")
        f.write(f"TYPE {' '.join(['F'] * nf)}\n")
        f.write(f"COUNT {' '.join(['1'] * nf)}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        inten = np.asarray(intensities).reshape(-1) if has_i else None
        for i in range(n):
            row = f"{pts[i, 0]:.6f} {pts[i, 1]:.6f} {pts[i, 2]:.6f}"
            if has_i:
                row += f" {inten[i]:.6f}"
            f.write(row + "\n")


def write_png(path, img) -> None:
    """An 8-bit grayscale [H, W] or RGB [H, W, 3] uint8 image as PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"write_png takes [H, W] or [H, W, 3], got "
                         f"{img.shape}")
    H, W = img.shape[:2]
    rows = img.reshape(H, -1)
    # filter type 0 (none) in front of every scanline
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], axis=1)

    def chunk(tag, data):
        body = tag + data
        return struct.pack(">I", len(data)) + body \
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
           + chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


def _lzw_codes(indices: bytes, min_size: int = 8):
    """GIF's variable-width LZW (codes of min_size + 1 to 12 bits, a clear
    code first and whenever the 4096-entry table fills) as bytes, the
    codes packed least significant bit first."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out, acc, nbits = bytearray(), 0, 0
    size, table, nxt = min_size + 1, {}, eoi + 1

    def put(code):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    put(clear)
    prefix = indices[0]
    for b in indices[1:]:
        key = (prefix << 8) | b
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        put(prefix)
        table[key] = nxt
        if nxt == (1 << size) and size < 12:
            size += 1
        nxt += 1
        if nxt == 4096:
            put(clear)
            size, table, nxt = min_size + 1, {}, eoi + 1
        prefix = b
    put(prefix)
    put(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_palette_indices(frame) -> np.ndarray:
    """A uint8 [H, W] frame is its own palette index (grey); an [H, W, 3]
    frame maps to the 3-3-2 RGB palette of ``write_gif``."""
    frame = np.asarray(frame, dtype=np.uint8)
    if frame.ndim == 2:
        return frame
    r, g, b = (frame[..., i].astype(np.int32) for i in range(3))
    return ((r >> 5) << 5 | (g >> 5) << 2 | (b >> 6)).astype(np.uint8)


def gif_palette(rgb: bool) -> np.ndarray:
    """[256, 3] uint8: 256 greys, or 8 x 8 x 4 levels of R, G and B."""
    i = np.arange(256)
    if not rgb:
        return np.repeat(i[:, None], 3, axis=1).astype(np.uint8)
    levels = lambda v, n: (v * 255 // (n - 1))  # noqa: E731
    return np.stack([levels(i >> 5, 8), levels((i >> 2) & 7, 8),
                     levels(i & 3, 4)], axis=1).astype(np.uint8)


def write_gif(path, frames, delay_cs: int = 10, loop: int = 0) -> None:
    """An animated GIF (standard library only) of uint8 frames, all grey
    [H, W] (a 256-grey palette: lossless) or all RGB [H, W, 3] (a fixed
    3-3-2 palette), ``delay_cs`` hundredths of a second each, looping
    ``loop`` times (0: for ever)."""
    frames = [np.asarray(f, dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("write_gif needs at least one frame")
    rgb = frames[0].ndim == 3
    if any(f.shape != frames[0].shape for f in frames) or \
            (rgb and frames[0].shape[2] != 3) or frames[0].ndim not in (2, 3):
        raise ValueError(f"write_gif takes frames of one shape, [H, W] or "
                         f"[H, W, 3]: {[f.shape for f in frames]}")
    H, W = frames[0].shape[:2]
    gif = bytearray(b"GIF89a" + struct.pack("<HHBBB", W, H, 0xF7, 0, 0))
    gif += gif_palette(rgb).tobytes()
    gif += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) \
        + b"\x00"
    for f in frames:
        gif += b"\x21\xF9\x04\x00" + struct.pack("<H", delay_cs) + b"\x00\x00"
        gif += b"\x2C" + struct.pack("<HHHHB", 0, 0, W, H, 0) + b"\x08"
        data = _lzw_codes(gif_palette_indices(f).tobytes())
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            gif += bytes([len(block)]) + block
        gif += b"\x00"
    gif += b"\x3B"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(bytes(gif))
