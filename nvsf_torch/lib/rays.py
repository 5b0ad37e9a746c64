"""Ray generation for LiDAR panoramas and pinhole cameras from flat pixel
indices (counterpart of the tensor half of ``nvsf_tpu/lib/rays.py``)."""

from __future__ import annotations

import math

import torch


def lidar_directions_from_indices(inds, H, W, intrinsics_lidar,
                                  intrinsics_hoz_lidar):
    """Flat pano indices [N] -> local ray directions [N, 3] (azimuth
    beta = -(col - W/2)/W * fov_hoz, inclination alpha = fov_up -
    row/H * fov, in degrees)."""
    fov_up, fov = map(float, intrinsics_lidar)
    fov_hoz = float(intrinsics_hoz_lidar[1])
    j = (inds // W).to(torch.float32)
    i = (inds % W).to(torch.float32)
    beta = -(i - W / 2) / W * fov_hoz / 180 * math.pi
    alpha = (fov_up - j / H * fov) / 180 * math.pi
    return torch.stack([torch.cos(alpha) * torch.cos(beta),
                        torch.cos(alpha) * torch.sin(beta),
                        torch.sin(alpha)], dim=-1)


def camera_directions_from_indices(inds, H, W, intrinsics):
    """Flat image indices [N] -> normalized local directions [N, 3] of a
    pinhole camera with 3x3 K, at pixel centers."""
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    j = (inds // W).to(torch.float32) + 0.5
    i = (inds % W).to(torch.float32) + 0.5
    d = torch.stack([(i - cx) / fx, (j - cy) / fy, torch.ones_like(i)],
                    dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def rays_from_pose(pose, directions):
    """pose [4, 4] sensor-to-world -> (rays_o [N, 3], rays_d [N, 3])."""
    rays_d = directions @ pose[:3, :3].T
    return pose[:3, 3].expand_as(rays_d), rays_d


def get_lidar_rays(pose, inds, H, W, intrinsics_lidar, intrinsics_hoz_lidar):
    return rays_from_pose(pose, lidar_directions_from_indices(
        inds, H, W, intrinsics_lidar, intrinsics_hoz_lidar))


def get_camera_rays(pose, inds, H, W, intrinsics):
    return rays_from_pose(pose, camera_directions_from_indices(
        inds, H, W, intrinsics))
