"""Pose and rotation utilities, numpy only: the port's copy of
``nvsf_tpu/lib/pose.py`` (the geometry helpers of the reference's
``nvsf/lib/tools.py:117-209`` and the novel-sensor pose deltas of
``base_dataset.py:170-231``).
"""

from __future__ import annotations

import numpy as np


def euler_to_matrix_xyz(angles_deg) -> np.ndarray:
    """Intrinsic-xyz Euler angles (degrees) -> 3x3 rotation.

    Matches ``scipy.spatial.transform.Rotation.from_euler('xyz', a, degrees=True)``
    as used at ``base_dataset.py:182``.
    """
    rx, ry, rz = np.asarray(angles_deg, dtype=np.float64) * np.pi / 180.0
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (w, x, y, z)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[1 + i] = 0.25 * s
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def quaternion_to_matrix(q) -> np.ndarray:
    """Quaternion (w, x, y, z), not necessarily unit -> 3x3 rotation."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0.0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def delta_transform(delta_orientation_deg, delta_position) -> np.ndarray:
    """4x4 right-multiplied sensor-pose delta (``base_dataset.py:182-184``)."""
    T = np.eye(4)
    T[:3, :3] = euler_to_matrix_xyz(delta_orientation_deg)
    T[:3, 3] = np.asarray(delta_position, dtype=np.float64)
    return T


def camera_delta_axes(x):
    """World-delta (front, left, up) -> camera axes (right, down, front).

    Matches the axis-swap helper at ``base_dataset.py:198-203``.
    """
    x = np.array(x, dtype=np.float64)
    x[[1, 2]] *= -1
    return x[[1, 2, 0]]


def recenter_and_scale_poses(poses: np.ndarray, offset, scale: float) -> np.ndarray:
    """Shift translations by -offset then scale (``base_dataset.py:229-231``)."""
    out = np.array(poses, dtype=np.float32, copy=True)
    out[:, :3, -1] = (out[:, :3, -1] - np.asarray(offset, dtype=np.float32)) * scale
    return out


def bbox_corners(position, size, quat_wxyz) -> np.ndarray:
    """8 corners of an oriented 3D box (``tools.py:167-209`` semantics)."""
    l, w, h = np.asarray(size, dtype=np.float64)
    xs = np.array([1, 1, 1, 1, -1, -1, -1, -1]) * (l / 2)
    ys = np.array([1, 1, -1, -1, 1, 1, -1, -1]) * (w / 2)
    zs = np.array([1, -1, 1, -1, 1, -1, 1, -1]) * (h / 2)
    R = quaternion_to_matrix(quat_wxyz)
    return (R @ np.stack([xs, ys, zs])).T + np.asarray(position,
                                                        dtype=np.float64)
