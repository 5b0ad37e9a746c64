"""Camera-image reading without an image package: an 8-bit PNG decoder and
the area-average downscale, written with the standard library and numpy so
that the port loads KITTI-360 camera images where OpenCV is not installed.

``read_png`` returns what ``cv2.cvtColor(cv2.imread(p, IMREAD_UNCHANGED),
BGR2RGB / BGRA2RGBA)`` returns (a grey image as ``imread`` returns it);
``resize_area`` is ``cv2.resize(img, (W, H), interpolation=INTER_AREA)``
for downscales of uint8 images, within one unit of the last place.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB, RGBA (palette and grey + alpha are
# not read)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(path):
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IEND":
            return


def _header(path):
    tag, ihdr = next(_chunks(path))
    if tag != b"IHDR":
        raise ValueError(f"{path}: the first chunk is {tag!r}, not IHDR")
    return struct.unpack(">IIBBBBB", ihdr)


def png_size(path):
    """(height, width) from the PNG header, without decoding the image."""
    W, H = _header(path)[:2]
    return H, W


def _unfilter(raw: bytes, H: int, row_bytes: int, bpp: int):
    """Undo the per-scanline filters (PNG spec 9.2). Returns the [H,
    row_bytes] uint8 image and the filter type of each row."""
    rows = np.frombuffer(raw, np.uint8).reshape(H, row_bytes + 1)
    kinds = rows[:, 0].copy()
    out = np.zeros((H, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.uint8)
    for y in range(H):
        line, kind = rows[y, 1:], kinds[y]
        if kind == 0:                          # none
            cur = line.copy()
        elif kind == 1:                        # sub: a running sum per byte
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:                        # up
            cur = line + prev
        elif kind in (3, 4):                   # average, Paeth: sequential
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(row_bytes):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = out[y]
    return out, kinds


def _decode(path):
    """(image as stored: [H, W] or [H, W, C] uint8, filter type per row)."""
    W, H, depth, ctype, comp, filt, interlace = _header(path)
    why = []
    if depth != 8:
        why.append(f"bit depth {depth} (only 8 is read)")
    if ctype not in _CHANNELS:
        why.append(f"colour type {ctype} (only grey, RGB and RGBA are read)")
    if interlace != 0:
        why.append("Adam7 interlacing")
    if comp != 0 or filt != 0:
        why.append(f"compression method {comp} / filter method {filt}")
    if why:
        raise ValueError(f"{path}: unsupported PNG: " + ", ".join(why))
    bpp = _CHANNELS[ctype]
    idat = b"".join(d for tag, d in _chunks(path) if tag == b"IDAT")
    raw = zlib.decompress(idat)
    if len(raw) != H * (W * bpp + 1):
        raise ValueError(f"{path}: {len(raw)} bytes of image data for a "
                         f"{H}x{W}x{bpp} image")
    img, kinds = _unfilter(raw, H, W * bpp, bpp)
    img = img.reshape(H, W, bpp)
    return (img[:, :, 0] if bpp == 1 else img), kinds


def read_png(path) -> np.ndarray:
    """An 8-bit grey ([H, W]), RGB or RGBA ([H, W, 3 or 4]) non-interlaced
    PNG as uint8, channels in RGB(A) order. Any other PNG raises a
    ValueError naming the file and the reason."""
    return _decode(path)[0]


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of INTER_AREA along one axis: output pixel i
    averages input [i * s, (i + 1) * s), s = n_in / n_out, each input
    pixel weighted by its overlap."""
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    hi = lo + s
    j = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0.0, None)
    return overlap / s


def resize_area(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA)`` for a
    uint8 [H0, W0] or [H0, W0, C] image downscaled (W <= W0, H <= H0): a
    box mean at integer ratios (rounded half up at 2x2 and half to even
    otherwise, as OpenCV's fast path), overlap-weighted box means at
    fractional ratios, rounded to nearest."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8 images, got {img.dtype}")
    H0, W0 = img.shape[:2]
    if W > W0 or H > H0:
        raise ValueError(f"resize_area only downscales: {W0}x{H0} -> "
                         f"{W}x{H}")
    if (W, H) == (W0, H0):
        return img.copy()
    x = img.astype(np.float64)
    sx, sy = W0 / W, H0 / H
    if sx == int(sx) and sy == int(sy):
        sx, sy = int(sx), int(sy)
        s = x.reshape(H, sy, W, sx, *img.shape[2:]).sum(axis=(1, 3))
        area = sx * sy
        if area == 4:
            out = np.floor((s + 2) / 4)
        else:                       # an f32 product, as OpenCV rounds it
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / area))
    else:
        ay, ax = _area_weights(H0, H), _area_weights(W0, W)
        rows = np.tensordot(ay, x, axes=(1, 0))            # [H, W0, ...]
        out = np.rint(np.moveaxis(np.tensordot(rows, ax, axes=(1, 1)),
                                  -1, 1))
    return np.clip(out, 0, 255).astype(np.uint8)
