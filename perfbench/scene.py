"""The benchmark's synthetic driving scene, made on the device: a
checkered ground plane and spheres, some of them moving, seen by a LiDAR
(depth, intensity, ray drop) and a pinhole camera (RGB) that drive along
+x. Frames are exact ray casts, laid out as a preprocessed KITTI-360
sequence is (panos of raydrop, intensity, depth * scale; poses scaled into
the unit box).

The configuration's ``scene`` block fixes the sensor sizes and the number
of objects; a layout seed places them (positions, radii, velocities within
the block's ranges)."""

from __future__ import annotations

import math

import numpy as np
import torch

# camera axes (x right, y down, z forward) in the world (x forward, z up)
_CAM_R = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))


def _uniform(gen, n, lo_hi, dev):
    lo, hi = lo_hi
    return torch.rand((n,), generator=gen, device=dev, dtype=torch.float64) \
        * (hi - lo) + lo


def objects(spec: dict, seed: int, device) -> torch.Tensor:
    """[n, 6] spheres (cx, cy, cz, r, vx, vy) in meters and meters a
    frame, drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    o = spec["objects"]
    rows = []
    for kind in ("static", "moving"):
        n = o[kind]
        ob = o[kind + "_box"]
        r = _uniform(gen, n, o["radius"], device)
        x = _uniform(gen, n, ob["x"], device)
        side = torch.where(torch.rand((n,), generator=gen, device=device) < 0.5,
                           -1.0, 1.0).to(torch.float64)
        y = side * _uniform(gen, n, ob["y_abs"], device)
        if kind == "moving":
            vx = _uniform(gen, n, o["speed"], device)
            vy = -side * _uniform(gen, n, o["drift"], device)
        else:
            vx = vy = torch.zeros((n,), dtype=torch.float64, device=device)
        rows.append(torch.stack([x, y, r, r, vx, vy], dim=-1))
    return torch.cat(rows)


def raycast(spec, objs, origin, dirs, fi):
    """origin [3], dirs [N, 3] (world, float64) at frame ``fi`` ->
    (depth [N], albedo [N]); depth 0 where nothing lies within max_depth."""
    N = dirs.shape[0]
    dev = dirs.device
    t_best = torch.full((N,), math.inf, dtype=torch.float64, device=dev)
    albedo = torch.zeros((N,), dtype=torch.float64, device=dev)
    dz = dirs[:, 2]
    ok = dz.abs() > 1e-9
    t_pl = torch.where(ok, (0.0 - origin[2]) / torch.where(ok, dz, 1.0),
                       math.inf)
    hit = (t_pl > 0.05) & torch.isfinite(t_pl)
    ts = torch.where(hit, t_pl, 0.0)
    px = origin[0] + ts * dirs[:, 0]
    py = origin[1] + ts * dirs[:, 1]
    chk = 0.3 + 0.2 * ((torch.floor(px) + torch.floor(py)) % 2 == 0)
    t_best = torch.where(hit, t_pl, t_best)
    albedo = torch.where(hit, chk, albedo)
    alb = spec["objects"]["albedo"]
    for k in range(objs.shape[0]):
        cx, cy, cz, r, vx, vy = objs[k]
        c = torch.stack([cx + vx * fi, cy + vy * fi, cz])
        oc = origin - c
        b = dirs @ oc
        disc = b * b - (oc @ oc - r * r)
        t_s = torch.where(disc > 0, -b - torch.sqrt(disc.clamp_min(0)),
                          math.inf)
        take = (disc > 0) & (t_s > 0.05) & (t_s < t_best)
        t_best = torch.where(take, t_s, t_best)
        albedo = torch.where(take, alb[k % len(alb)], albedo)
    depth = torch.where(torch.isfinite(t_best)
                        & (t_best < spec["max_depth"]), t_best, 0.0)
    return depth, albedo


def make_scene(spec: dict, seed: int, device) -> dict:
    """The scene of ``seed`` as host float32 numpy arrays: poses_lidar,
    panos, poses, images, intrinsics, times, frame_ids, and the sensor
    constants."""
    dev = torch.device(device)
    F = spec["num_frames"]
    Hl, Wl = spec["lidar_hw"]
    H, W = spec["camera_hw"]
    fx, fy, cx, cy = spec["camera_K"]
    sc = spec["scale"]
    objs = objects(spec, seed, dev)
    f64 = torch.float64

    j, i = torch.meshgrid(torch.arange(Hl, dtype=f64, device=dev),
                          torch.arange(Wl, dtype=f64, device=dev),
                          indexing="ij")
    up, fov = spec["intrinsics_lidar"]
    beta = -(i - Wl / 2) / Wl * spec["intrinsics_hoz_lidar"][1] / 180 * math.pi
    alpha = (up - j / Hl * fov) / 180 * math.pi
    dirs_l = torch.stack([torch.cos(alpha) * torch.cos(beta),
                          torch.cos(alpha) * torch.sin(beta),
                          torch.sin(alpha)], dim=-1).reshape(-1, 3)
    jj, ii = torch.meshgrid(torch.arange(H, dtype=f64, device=dev) + 0.5,
                            torch.arange(W, dtype=f64, device=dev) + 0.5,
                            indexing="ij")
    cam = torch.stack([(ii - cx) / fx, (jj - cy) / fy, torch.ones_like(ii)],
                      dim=-1).reshape(-1, 3)
    cam = cam / torch.linalg.norm(cam, dim=-1, keepdim=True)
    R = torch.tensor(_CAM_R, dtype=f64, device=dev).T     # cam -> world
    dirs_c = cam @ R.T

    panos = torch.empty((F, Hl, Wl, 3), dtype=torch.float32, device=dev)
    images = torch.empty((F, H, W, 3), dtype=torch.float32, device=dev)
    poses_l = torch.eye(4, dtype=f64, device=dev).repeat(F, 1, 1)
    poses_c = poses_l.clone()
    poses_c[:, :3, :3] = R
    for fi in range(F):
        o = torch.tensor([spec["sensor_speed"] * fi, 0.0,
                          spec["sensor_height"]], dtype=f64, device=dev)
        poses_l[fi, :3, 3] = o
        poses_c[fi, :3, 3] = o
        d, a = raycast(spec, objs, o, dirs_l, fi)
        drop = (d > 0).to(f64)
        panos[fi] = torch.stack([drop, a * drop, d * sc], -1).reshape(
            Hl, Wl, 3).to(torch.float32)
        dc, ac = raycast(spec, objs, o, dirs_c, fi)
        shade = ac.clamp(0, 1)
        rgb = torch.stack([shade, shade * 0.8, shade * 0.6], -1)
        rgb = torch.where(dc[:, None] > 0, rgb, 1.0)
        images[fi] = rgb.reshape(H, W, 3).to(torch.float32)
    poses_l[:, :3, 3] *= sc
    poses_c[:, :3, 3] *= sc
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    return {
        "poses_lidar": poses_l.to(torch.float32).cpu().numpy(),
        "panos": panos.cpu().numpy(),
        "poses": poses_c.to(torch.float32).cpu().numpy(),
        "images": images.cpu().numpy(),
        "intrinsics": K,
        "times": (np.arange(F) / max(F - 1, 1)).astype(np.float32),
        "frame_ids": np.arange(F, dtype=np.float32),
        "intrinsics_lidar": tuple(spec["intrinsics_lidar"]),
        "intrinsics_hoz_lidar": tuple(spec["intrinsics_hoz_lidar"]),
    }


def returns_grid(c: dict, scene: dict, density: float, device
                 ) -> torch.Tensor:
    """The LiDAR occupancy grid [G, G, G] that a field fitted to the scene
    settles to: ``density`` in every cell that holds a LiDAR return of any
    frame, 0 elsewhere (cells over [-bound, bound]^3, as the renderer
    indexes them)."""
    from perfbench.reference import model as M
    dev = torch.device(device)
    G, b = c["occ_grid_size"], float(c["bound"])
    panos = torch.as_tensor(scene["panos"], device=dev)
    F, Hl, Wl = panos.shape[:3]
    inds = torch.arange(Hl * Wl, device=dev)
    dirs = M.lidar_dirs(inds, Hl, Wl, scene["intrinsics_lidar"],
                        scene["intrinsics_hoz_lidar"])
    grid = torch.zeros((G,) * 3, device=dev)
    for fi in range(F):
        pose = torch.as_tensor(scene["poses_lidar"][fi], device=dev)
        ro, rd = M.to_world(pose, dirs)
        depth = panos[fi, ..., 2].reshape(-1)
        hit = panos[fi, ..., 0].reshape(-1) > 0
        xyz = (ro + rd * depth[:, None])[hit]
        ijk = torch.clamp(((xyz / b + 1.0) * 0.5 * G).to(torch.int64), 0,
                          G - 1)
        grid.view(-1)[(ijk[:, 0] * G + ijk[:, 1]) * G + ijk[:, 2]] = density
    return grid
