"""LiDAR <-> panorama (range image) conversions, fully vectorized.

The port's own copy of ``nvsf_tpu/lib/convert.py``. Reimplements the
semantics of the reference's per-point Python loops
(``nvsf/lib/convert.py:105-402``) as vectorized scatter-min projections.
``lidar_to_pano_with_intensities`` runs the native host helper
(``nvsf_torch/native``), as the JAX package's does; its numpy version,
``lidar_to_pano_with_intensities_numpy``, is the plain version the tests
hold the helper to.

Conventions (identical to the reference):
  - pano row 0 is the TOP beam (max inclination = fov_up), row H-1 the bottom.
  - pano col sweeps azimuth: beta = fov_hoz_up - atan2(y, x), mapped to
    [0, W) with column width fov_hoz/W degrees.
  - depth 0 in a pano pixel means "ray dropped" (no return).
"""

from __future__ import annotations

import numpy as np

from nvsf_torch.native import binding as native


def lidar_to_pano_with_intensities(
    local_points_with_intensities: np.ndarray,
    lidar_H: int,
    lidar_W: int,
    lidar_K,
    lidar_K_hoz,
    max_depth: float = 80.0,
):
    """Project an (N, 4) [x, y, z, intensity] point cloud to (H, W) pano.

    Z-min conflict resolution per pixel (closest return wins), matching
    ``convert.py:105-181``. Returns (pano_depth, pano_intensity). Runs the
    native helper, which is built at first use and raises if it cannot be.
    """
    return native.lidar_to_pano_with_intensities(
        local_points_with_intensities, lidar_H, lidar_W, lidar_K,
        lidar_K_hoz, max_depth)


def lidar_to_pano_with_intensities_numpy(
    local_points_with_intensities: np.ndarray,
    lidar_H: int,
    lidar_W: int,
    lidar_K,
    lidar_K_hoz,
    max_depth: float = 80.0,
):
    """``lidar_to_pano_with_intensities`` in numpy (its plain version)."""
    pts = np.asarray(local_points_with_intensities, dtype=np.float64)
    r, c, d, i = _pixels(pts, lidar_H, lidar_W, lidar_K, lidar_K_hoz,
                         max_depth)
    # scatter-min: sort by descending distance; the final (closest) write wins.
    order = np.argsort(-d, kind="stable")
    pano = np.zeros((lidar_H, lidar_W), dtype=np.float64)
    inten = np.zeros((lidar_H, lidar_W), dtype=np.float64)
    pano[r[order], c[order]] = d[order]
    inten[r[order], c[order]] = i[order]
    return pano, inten


def lidar_to_pano(local_points, lidar_H, lidar_W, lidar_K, lidar_K_hoz,
                  max_depth: float = 80.0) -> np.ndarray:
    """(N, 3) points -> (H, W) depth pano (``convert.py:183-218``)."""
    pts = np.concatenate(
        [np.asarray(local_points), np.zeros((len(local_points), 1))], axis=1)
    pano, _ = lidar_to_pano_with_intensities(
        pts, lidar_H, lidar_W, lidar_K, lidar_K_hoz, max_depth)
    return pano


def pano_direction_grid(H: int, W: int, lidar_K, lidar_K_hoz) -> np.ndarray:
    """Unit ray directions for every pano pixel, (H, W, 3).

    Same per-pixel angles as the reference inverse projection
    (``convert.py:241-254``) and ray generation (``dataset_utils.py:512-526``).
    """
    fov_up, fov = float(lidar_K[0]), float(lidar_K[1])
    fov_hoz_up, fov_hoz = float(lidar_K_hoz[0]), float(lidar_K_hoz[1])
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    beta = -(i - W / 2) / W * fov_hoz / 180 * np.pi
    alpha = (fov_up - j / H * fov) / 180 * np.pi
    return np.stack(
        [np.cos(alpha) * np.cos(beta),
         np.cos(alpha) * np.sin(beta),
         np.sin(alpha)], axis=-1)


def pano_to_lidar_with_intensities(pano: np.ndarray, intensities: np.ndarray,
                                   lidar_K, lidar_K_hoz) -> np.ndarray:
    """(H, W) depth + intensity pano -> (N, 4) point cloud (``convert.py:221-268``)."""
    H, W = pano.shape
    dirs = pano_direction_grid(H, W, lidar_K, lidar_K_hoz)
    local_points = dirs * pano.reshape(H, W, 1)
    pts = np.concatenate([local_points, intensities.reshape(H, W, 1)], axis=2)
    idx = np.where(pano != 0.0)
    return pts[idx]


def pano_to_lidar(pano: np.ndarray, lidar_K, lidar_K_hoz) -> np.ndarray:
    """(H, W) depth pano -> (N, 3) point cloud (``convert.py:271-291``)."""
    pts = pano_to_lidar_with_intensities(
        pano, np.zeros_like(pano), lidar_K, lidar_K_hoz)
    return pts[:, :3]


def _pixels(pts, lidar_H, lidar_W, lidar_K, lidar_K_hoz, max_depth):
    """Pixel rows, columns, distances and intensities of the points that
    project inside the pano and nearer than ``max_depth``."""
    local_points = pts[:, :3]
    intensities = pts[:, 3]
    fov_up, fov = float(lidar_K[0]), float(lidar_K[1])
    fov_down = fov - fov_up
    fov_hoz_up, fov_hoz = float(lidar_K_hoz[0]), float(lidar_K_hoz[1])
    dists = np.linalg.norm(local_points, axis=1)
    x, y, z = local_points.T
    beta = fov_hoz_up * np.pi / 180 - np.arctan2(y, x)
    alpha = np.arctan2(z, np.sqrt(x ** 2 + y ** 2)) + fov_down / 180 * np.pi
    c = np.rint(beta / ((fov_hoz * np.pi / 180) / lidar_W)).astype(np.int64)
    r = np.rint(lidar_H - alpha / (fov / 180 * np.pi / lidar_H)) \
        .astype(np.int64)
    valid = ((dists < max_depth) & (r >= 0) & (r < lidar_H)
             & (c >= 0) & (c < lidar_W))
    return r[valid], c[valid], dists[valid], intensities[valid]


def lidar_to_pano_with_intensities_with_bbox_mask(
        local_points_with_intensities, bbox_local, lidar_H, lidar_W,
        lidar_K, lidar_K_hoz, max_depth: float = 80.0):
    """The projection of the points inside an axis-aligned local box
    (``convert.py:10-102``, the NeRF-MVL pipeline's).

    bbox_local: (2, 3) [[xmin, ymin, zmin], [xmax, ymax, zmax]].
    """
    pts = np.asarray(local_points_with_intensities, np.float64)
    lo, hi = np.asarray(bbox_local[0]), np.asarray(bbox_local[1])
    inside = np.all((pts[:, :3] >= lo) & (pts[:, :3] <= hi), axis=1)
    return lidar_to_pano_with_intensities(
        pts[inside], lidar_H, lidar_W, lidar_K, lidar_K_hoz, max_depth)


def lidar_to_pano_multi_return(local_points_with_intensities, lidar_H,
                               lidar_W, lidar_K, lidar_K_hoz, n_returns=2,
                               max_depth: float = 80.0):
    """Multi-return z-buffer projection (``convert.py:294-402``): each
    pixel keeps its ``n_returns`` closest returns, near to far.

    Returns (pano [R, H, W], intensities [R, H, W]).
    """
    pts = np.asarray(local_points_with_intensities, np.float64)
    r, c, d, i = _pixels(pts, lidar_H, lidar_W, lidar_K, lidar_K_hoz,
                         max_depth)
    pix = r * lidar_W + c
    # sort by (pixel, depth); a return's rank is its place in its pixel
    order = np.lexsort((d, pix))
    pix, d, i = pix[order], d[order], i[order]
    first = np.ones(len(pix), bool)
    first[1:] = pix[1:] != pix[:-1]
    starts = np.flatnonzero(first)
    rank = np.arange(len(pix)) - np.repeat(
        starts, np.diff(np.append(starts, len(pix))))
    pano = np.zeros((n_returns, lidar_H * lidar_W))
    inten = np.zeros((n_returns, lidar_H * lidar_W))
    for ri in range(n_returns):
        sel = rank == ri
        pano[ri, pix[sel]] = d[sel]
        inten[ri, pix[sel]] = i[sel]
    return (pano.reshape(n_returns, lidar_H, lidar_W),
            inten.reshape(n_returns, lidar_H, lidar_W))
