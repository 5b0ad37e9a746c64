"""Scene data held as host numpy arrays, and the loader of a preprocessed
sequence with its novel-sensor overrides (counterpart of
``nvsf_tpu/data/dataset.py``, which cannot be imported without JAX). Camera
images are read by the port's own PNG decoder and area resize
(``lib/image.py``), so no image package is needed. The trainer moves the
arrays to its device once."""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from nvsf_torch.lib import convert, pose as poselib, rays as raylib
from nvsf_torch.lib.image import read_png, resize_area


@dataclass
class SceneData:
    """All frames of one sequence."""
    poses_lidar: np.ndarray                 # [F, 4, 4] lidar2world (scaled)
    images_lidar: Optional[np.ndarray]      # [F, Hl, Wl, 3] raydrop,
                                            # intensity, depth * scale
    H_lidar: int = 66
    W_lidar: int = 1030
    intrinsics_lidar: tuple = (2.0, 26.9)
    intrinsics_hoz_lidar: tuple = (180.0, 360.0)
    poses: Optional[np.ndarray] = None      # [F, 4, 4] cam2world (scaled)
    images: Optional[np.ndarray] = None     # [F, H, W, 3 or 4]
    image_depths: Optional[np.ndarray] = None  # [F, H, W, 1] meters
    H: int = 0
    W: int = 0
    intrinsics: Optional[np.ndarray] = None  # [3, 3]
    times: np.ndarray = None                # [F] in [0, 1]
    frame_ids: np.ndarray = None            # [F]
    num_frames: int = 0
    annotations: list = field(default_factory=list)
    split: str = "train"

    @property
    def has_gt(self) -> bool:
        return self.images_lidar is not None or self.images is not None

    def __len__(self):
        return len(self.poses_lidar) if self.poses_lidar is not None \
            else len(self.poses)


# ----------------------------------------------------------------------
# transforms-json loader (reference schema, ``base_dataset.py:60-157``)
# ----------------------------------------------------------------------

def load_scene(root_path: str, sequence_id: str, split: str, *,
               scale: float, offset, enable_lidar=True, enable_rgb=True,
               intrinsics_lidar=(2.0, 26.9),
               intrinsics_hoz_lidar=(180.0, 360.0),
               novel_sensor: Optional[dict] = None) -> SceneData:
    """Load ``transforms_{seq}_{split}.json`` + pano npys (+ images).

    ``novel_sensor`` (test-time only) carries the pose/intrinsics overrides of
    ``base_dataset.py:170-227``: keys delta_position, delta_orientation,
    H_lidar_new, W_lidar_new, intrinsics_lidar_new, intrinsics_hoz_lidar_new,
    delta_pos_camera, delta_orient_camera, H_new, W_new.
    """
    tpath = os.path.join(root_path, "train", str(sequence_id),
                         f"transforms_{sequence_id}_{split}.json")
    with open(tpath) as f:
        tf = json.load(f)

    H = int(tf.get("h", 0)) or None
    W = int(tf.get("w", 0)) or None
    H_lidar = int(tf["h_lidar"])
    W_lidar = int(tf["w_lidar"])
    num_frames = tf["num_frames"]
    frame_start, frame_end = tf["frame_start"], tf["frame_end"]
    frames = sorted(tf["frames"], key=lambda d: d["file_path"])

    fl_x = tf.get("fl_x", tf.get("fl_y"))
    fl_y = tf.get("fl_y", tf.get("fl_x"))
    cx = tf.get("cx", (W or 0) / 2)
    cy = tf.get("cy", (H or 0) / 2)
    K = np.array([[fl_x, 0, cx], [0, fl_y, cy], [0, 0, 1]], np.float64)

    poses, images, poses_lidar, images_lidar = [], [], [], []
    image_depths, times, frame_ids = [], [], []
    for f in frames:
        pose_lidar = np.array(f["lidar2world"], np.float32)
        pc = np.load(os.path.join(root_path, f["lidar_file_path"]))
        ray_drop = (pc[:, :, 2] != 0.0).astype(np.float32)[..., None]
        image_lidar = np.concatenate(
            [ray_drop, pc[:, :, 1:2], pc[:, :, 2:3] * scale], axis=-1)
        poses_lidar.append(pose_lidar)
        images_lidar.append(image_lidar)
        times.append((f["frame_id"] - frame_start)
                     / max(frame_end - frame_start, 1))
        frame_ids.append(f["frame_id"])

        if enable_rgb:
            pose = np.array(f["transform_matrix"], np.float32)
            img = read_png(os.path.join(root_path, f["file_path"]))
            if H and (img.shape[0] != H or img.shape[1] != W):
                img = resize_area(img, W, H)
            poses.append(pose)
            images.append(img.astype(np.float32) / 255.0)
            # lidar -> camera pseudo-depth (``base_dataset.py:152-157``)
            pts = convert.pano_to_lidar(pc[:, :, 2], intrinsics_lidar,
                                        intrinsics_hoz_lidar)
            pts2d = raylib.lidar_points_to_image_plane(
                pts, K, np.linalg.inv(pose.astype(np.float64)) @ pose_lidar)
            image_depths.append(raylib.lidar_depth_image(pts2d, (H, W)))

    scene = SceneData(
        poses_lidar=np.stack(poses_lidar),
        images_lidar=np.stack(images_lidar) if images_lidar else None,
        H_lidar=H_lidar, W_lidar=W_lidar,
        intrinsics_lidar=tuple(intrinsics_lidar),
        intrinsics_hoz_lidar=tuple(intrinsics_hoz_lidar),
        poses=np.stack(poses) if poses else None,
        images=np.stack(images) if images else None,
        image_depths=np.stack(image_depths) if image_depths else None,
        H=H or 0, W=W or 0, intrinsics=K,
        times=np.asarray(times, np.float32),
        frame_ids=np.asarray(frame_ids, np.float32),
        num_frames=num_frames, split=split)
    if novel_sensor:
        scene = apply_novel_sensor(scene, novel_sensor)
    scene.poses_lidar = poselib.recenter_and_scale_poses(scene.poses_lidar,
                                                         offset, scale)
    if scene.poses is not None:
        scene.poses = poselib.recenter_and_scale_poses(scene.poses, offset,
                                                       scale)
    return scene


def apply_novel_sensor(scene: SceneData, ns: dict,
                       scale: float = 1.0) -> SceneData:
    """The novel-sensor overrides of ``base_dataset.py:170-227`` (test
    time): pose deltas right-multiplied onto the LiDAR and camera poses
    (positions in meters, times ``scale`` for poses that are already
    scaled), a new beam count (+2 rows for the extreme beams), width and
    FoV, a new image size. The ground truth no longer applies and is
    dropped. Keys: delta_position, delta_orientation, H_lidar_new,
    W_lidar_new, intrinsics_lidar_new, intrinsics_hoz_lidar_new,
    delta_pos_camera, delta_orient_camera, H_new, W_new."""
    out = dataclasses.replace(scene, images_lidar=None, images=None,
                              image_depths=None)
    T = poselib.delta_transform(
        ns.get("delta_orientation", [0, 0, 0]),
        np.asarray(ns.get("delta_position", [0, 0, 0])) * scale)
    out.poses_lidar = (scene.poses_lidar @ T).astype(np.float32)
    if ns.get("H_lidar_new"):
        out.H_lidar = int(ns["H_lidar_new"]) + 2
    if ns.get("W_lidar_new"):
        out.W_lidar = int(ns["W_lidar_new"])
    if any(ns.get("intrinsics_lidar_new", [0, 0])):
        out.intrinsics_lidar = tuple(ns["intrinsics_lidar_new"])
    if any(ns.get("intrinsics_hoz_lidar_new", [0, 0])):
        out.intrinsics_hoz_lidar = tuple(ns["intrinsics_hoz_lidar_new"])
    if scene.poses is not None:
        Tc = poselib.delta_transform(
            poselib.camera_delta_axes(ns.get("delta_orient_camera",
                                             [0, 0, 0])),
            poselib.camera_delta_axes(ns.get("delta_pos_camera",
                                             [0, 0, 0])) * scale)
        out.poses = (scene.poses @ Tc).astype(np.float32)
        if ns.get("H_new") or ns.get("W_new"):
            K = np.array(scene.intrinsics, np.float64)
            K[0, 2] *= ns["W_new"] / scene.W if ns.get("W_new") else 1
            K[1, 2] *= ns["H_new"] / scene.H if ns.get("H_new") else 1
            out.intrinsics = K
            out.H = ns.get("H_new") or scene.H
            out.W = ns.get("W_new") or scene.W
    return out
