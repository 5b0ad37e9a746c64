"""ctypes binding of the native host helpers (``nvsf_native.cpp``): the
scatter-min LiDAR -> pano projection, pano -> points, and the one-pass
velodyne ``.bin`` -> range view of the preprocessing.

The library is compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/nvsf_torch_native/<hash of source and flags>/`` at the root of the
checkout, under a temporary name that is then renamed into place, so that
processes building at once never load a half-written file. A failed build
raises with the compiler's output; nothing falls back to numpy quietly
(the numpy versions in ``nvsf_torch/lib/convert.py`` are the plain
versions the tests hold these to).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "nvsf_native.cpp"
BUILD_ROOT = SRC.parent.parent.parent / "build" / "nvsf_torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None

_D = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_F = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
_I64, _DBL = ctypes.c_int64, ctypes.c_double


def _build() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SRC.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libnvsf_native.so"
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native host helpers need g++ on PATH, and "
                           "none was found")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libnvsf_native.tmp.{os.getpid()}.so"
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native host helpers failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded helper library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            lib.lidar_to_pano_with_intensities.argtypes = [
                _D, _I64, _I64, _I64, _DBL, _DBL, _DBL, _DBL, _DBL, _D, _D]
            lib.lidar_to_pano_with_intensities.restype = None
            lib.pano_to_lidar_with_intensities.argtypes = [
                _D, _D, _I64, _I64, _DBL, _DBL, _DBL, _DBL, _D]
            lib.pano_to_lidar_with_intensities.restype = _I64
            lib.velodyne_bin_to_rangeview.argtypes = [
                ctypes.c_char_p, _I64, _I64, _DBL, _DBL, _DBL, _DBL, _DBL,
                _F]
            lib.velodyne_bin_to_rangeview.restype = ctypes.c_int32
            _lib = lib
    return _lib


def _angles(K, K_hoz):
    return float(K[0]), float(K[1]), float(K_hoz[0]), float(K_hoz[1])


def lidar_to_pano_with_intensities(pts, H, W, K, K_hoz, max_depth=80.0):
    """(N, 4) [x, y, z, intensity] -> (pano, intensity), each (H, W) f64;
    the closest return wins a pixel."""
    pts = np.ascontiguousarray(pts, np.float64)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be [N, 4] x, y, z, intensity, got "
                         f"{pts.shape}")
    pano = np.zeros((H, W), np.float64)
    inten = np.zeros((H, W), np.float64)
    library().lidar_to_pano_with_intensities(
        pts, len(pts), H, W, *_angles(K, K_hoz), float(max_depth), pano,
        inten)
    return pano, inten


def pano_to_lidar_with_intensities(pano, inten, K, K_hoz):
    """(H, W) depth and intensity panos -> (M, 4) points of the non-zero
    pixels, row-major."""
    pano = np.ascontiguousarray(pano, np.float64)
    inten = np.ascontiguousarray(inten, np.float64)
    if pano.ndim != 2 or inten.shape != pano.shape:
        raise ValueError(f"pano and intensity must be one [H, W] shape, got "
                         f"{pano.shape} and {inten.shape}")
    H, W = pano.shape
    out = np.zeros((H * W, 4), np.float64)
    m = library().pano_to_lidar_with_intensities(
        pano, inten, H, W, *_angles(K, K_hoz), out)
    return out[:m]


def velodyne_bin_to_rangeview(path, H, W, K, K_hoz, max_depth=80.0):
    """A raw velodyne ``.bin`` file -> (H, W, 3) f32 [0, intensity,
    depth] range view in one pass."""
    out = np.zeros((H, W, 3), np.float32)
    rc = library().velodyne_bin_to_rangeview(
        str(path).encode(), H, W, *_angles(K, K_hoz), float(max_depth), out)
    if rc != 0:
        raise IOError(f"velodyne_bin_to_rangeview({path}) failed: rc={rc}")
    return out
