"""Analytic synthetic scene (ground plane + spheres, one moving) for
end-to-end tests and benchmarks without KITTI-360 data (counterpart of
``nvsf_tpu/data/synthetic.py``, which cannot be imported without JAX; the
same spec gives the same arrays).

Generates LiDAR panos (raydrop, intensity, depth*scale) and camera RGB frames
from exact ray-casting, in the same layout as the reference's preprocessed
data.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from nvsf_torch.data.dataset import SceneData
from nvsf_tpu.lib import convert


@dataclass
class SyntheticSceneSpec:
    num_frames: int = 8
    H_lidar: int = 32
    W_lidar: int = 96
    H: int = 40
    W: int = 56
    intrinsics_lidar: tuple = (10.0, 40.0)
    intrinsics_hoz_lidar: tuple = (180.0, 360.0)
    max_depth: float = 25.0
    scale: float = 1.0 / 26.0       # world meters -> box units
    # scene content (world meters)
    ground_z: float = 0.0
    spheres: tuple = (
        # (cx, cy, cz, r, albedo, vx, vy)  — v in m/frame (dynamic if != 0)
        (6.0, 3.0, 1.0, 1.0, 0.9, 0.0, 0.0),
        (8.0, -4.0, 1.5, 1.5, 0.6, 0.0, 0.0),
        (5.0, 0.0, 1.0, 1.0, 0.8, 0.4, 0.15),
    )
    sensor_height: float = 1.7
    sensor_speed: float = 0.3       # m/frame along +x

    def lidar_pose(self, fi: int) -> np.ndarray:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [self.sensor_speed * fi, 0.0, self.sensor_height]
        return T

    def camera_pose(self, fi: int) -> np.ndarray:
        # camera looks along +x (world) with standard cv axes:
        # cam x -> world -y? Use columns mapping cam(x right, y down, z fwd)
        T = np.eye(4, dtype=np.float32)
        R = np.array([[0, 0, 1],     # world x = cam z (forward)
                      [-1, 0, 0],    # world y = -cam x
                      [0, -1, 0]],   # world z = -cam y
                     np.float32).T
        T[:3, :3] = R.T
        T[:3, 3] = [self.sensor_speed * fi, 0.0, self.sensor_height]
        return T

    @property
    def intrinsics(self) -> np.ndarray:
        f = 0.8 * self.W
        return np.array([[f, 0, self.W / 2], [0, f, self.H / 2], [0, 0, 1]],
                        np.float64)


def _raycast(spec: SyntheticSceneSpec, origins, dirs, fi):
    """origins, dirs: [N, 3] world. Returns (depth [N], albedo [N], obj [N])."""
    N = origins.shape[0]
    t_best = np.full(N, np.inf)
    albedo = np.zeros(N)
    # ground plane z = ground_z
    dz = dirs[:, 2]
    safe_dz = np.where(np.abs(dz) > 1e-9, dz, 1.0)
    t_pl = np.where(np.abs(dz) > 1e-9,
                    (spec.ground_z - origins[:, 2]) / safe_dz, np.inf)
    hit = (t_pl > 0.05) & np.isfinite(t_pl)
    # checkerboard ground albedo (evaluated only where the plane is hit)
    t_safe = np.where(hit, t_pl, 0.0)
    px = origins[:, 0] + t_safe * dirs[:, 0]
    py = origins[:, 1] + t_safe * dirs[:, 1]
    chk = 0.3 + 0.2 * (((np.floor(px) + np.floor(py)) % 2 == 0))
    t_best = np.where(hit, t_pl, t_best)
    albedo = np.where(hit, chk, albedo)
    # spheres
    for (cx, cy, cz, r, alb, vx, vy) in spec.spheres:
        c = np.array([cx + vx * fi, cy + vy * fi, cz])
        oc = origins - c
        b = np.sum(oc * dirs, axis=1)
        cq = np.sum(oc * oc, axis=1) - r * r
        disc = b * b - cq
        ok = disc > 0
        t_s = np.where(ok, -b - np.sqrt(np.maximum(disc, 0)), np.inf)
        ok = ok & (t_s > 0.05) & (t_s < t_best)
        t_best = np.where(ok, t_s, t_best)
        albedo = np.where(ok, alb, albedo)
    depth = np.where(np.isfinite(t_best) & (t_best < spec.max_depth),
                     t_best, 0.0)
    return depth, albedo


def make_synthetic_scene(spec: SyntheticSceneSpec = SyntheticSceneSpec(),
                         split: str = "train",
                         val_frames: Optional[list] = None) -> SceneData:
    Hl, Wl = spec.H_lidar, spec.W_lidar
    H, W = spec.H, spec.W
    K = spec.intrinsics

    dirs_pano = convert.pano_direction_grid(
        Hl, Wl, spec.intrinsics_lidar, spec.intrinsics_hoz_lidar
    ).reshape(-1, 3)

    # camera pixel dirs (pinhole, +0.5 centers)
    jj, ii = np.meshgrid(np.arange(H) + 0.5, np.arange(W) + 0.5,
                         indexing="ij")
    cam_dirs = np.stack([(ii - K[0, 2]) / K[0, 0],
                         (jj - K[1, 2]) / K[1, 1],
                         np.ones_like(ii)], axis=-1).reshape(-1, 3)
    cam_dirs /= np.linalg.norm(cam_dirs, axis=-1, keepdims=True)

    all_frames = list(range(spec.num_frames))
    if val_frames is None:
        val_frames = [spec.num_frames // 2]
    sel = {"train": [f for f in all_frames if f not in val_frames],
           "val": val_frames, "test": all_frames,
           "all": all_frames}[split]

    poses_l, panos, poses_c, images, image_depths = [], [], [], [], []
    times, fids, annotations = [], [], []
    for fi in sel:
        # 3D annotations for dynamic spheres (axis-aligned 8-vertex boxes in
        # world meters, like KITTI-360's per-frame bboxes)
        frame_ann = []
        for (cx, cy, cz, r, _alb, vx, vy) in spec.spheres:
            if vx != 0.0 or vy != 0.0:
                c = np.array([cx + vx * fi, cy + vy * fi, cz])
                corners = np.array(
                    [[sx, sy, sz] for sx in (-r, r) for sy in (-r, r)
                     for sz in (-r, r)]) + c
                frame_ann.append({"vertices": corners,
                                  "label": "dynamic_sphere"})
        annotations.append(frame_ann)
        Tl = spec.lidar_pose(fi)
        d_world = dirs_pano @ Tl[:3, :3].T
        o_world = np.broadcast_to(Tl[:3, 3], d_world.shape)
        depth, alb = _raycast(spec, o_world, d_world, fi)
        raydrop = (depth > 0).astype(np.float32)
        pano = np.stack([raydrop,
                         alb * raydrop,
                         depth * spec.scale], axis=-1).reshape(Hl, Wl, 3)
        poses_l.append(Tl)
        panos.append(pano.astype(np.float32))

        Tc = spec.camera_pose(fi)
        dc = cam_dirs @ Tc[:3, :3].T
        oc = np.broadcast_to(Tc[:3, 3], dc.shape)
        cdepth, calb = _raycast(spec, oc, dc, fi)
        shade = np.clip(calb, 0, 1)
        rgb = np.stack([shade, shade * 0.8, shade * 0.6], axis=-1)
        rgb = np.where(cdepth[:, None] > 0, rgb, 1.0)  # white sky
        images.append(rgb.reshape(H, W, 3).astype(np.float32))
        image_depths.append(cdepth.reshape(H, W, 1).astype(np.float32))
        poses_c.append(Tc)
        times.append(fi / max(spec.num_frames - 1, 1))
        fids.append(fi)

    # poses are already in metric world; scale them into the unit box
    poses_l = np.stack(poses_l)
    poses_c = np.stack(poses_c)
    poses_l[:, :3, 3] *= spec.scale
    poses_c[:, :3, 3] *= spec.scale

    return SceneData(
        poses_lidar=poses_l, images_lidar=np.stack(panos),
        H_lidar=Hl, W_lidar=Wl,
        intrinsics_lidar=spec.intrinsics_lidar,
        intrinsics_hoz_lidar=spec.intrinsics_hoz_lidar,
        poses=poses_c, images=np.stack(images),
        image_depths=np.stack(image_depths),
        H=H, W=W, intrinsics=K,
        times=np.asarray(times, np.float32),
        frame_ids=np.asarray(fids, np.float32),
        num_frames=spec.num_frames, split=split,
        annotations=annotations)
