"""Test mode: render every frame of a scene, with or without ground truth
(novel-sensor synthesis), and write the pano and image PNGs and the LiDAR-
and world-frame point clouds (counterpart of
``nvsf_tpu/train/test_mode.py``, which rebuilds
``nvsf/nerf/trainer.py:1109-1283``), and with ``write_video`` the depth
and RGB frames as animated GIFs. The JAX package writes mp4 where an
ffmpeg backend exists and GIF otherwise; the port always writes GIF, with
its standard-library writer (``lib/tools.py::write_gif``)."""

from __future__ import annotations

import os

import numpy as np

from nvsf_torch.lib import convert
from nvsf_torch.lib.tools import write_gif, write_pcd, write_png


def _to_u8(a, vmax=None):
    a = np.asarray(a, np.float32)
    vmax = vmax or max(float(a.max()), 1e-8)
    return (np.clip(a / vmax, 0, 1) * 255).astype(np.uint8)


def run_test(trainer, scene, *, save_dir, name="test", use_refine=False,
             write_video=False, log_fn=print):
    """Render each frame of ``scene`` from the EMA field on the trainer's
    device and write ``{name}_{frame:04d}_*`` artifacts into ``save_dir``;
    with ``write_video`` also ``{name}_depth.gif`` and ``{name}_rgb.gif``
    (10 frames a second, looping; ``nvsf_tpu/train/test_mode.py:20-46``)."""
    cfg = trainer.cfg
    os.makedirs(save_dir, exist_ok=True)
    frames = {"depth": [], "rgb": []}
    for fi in range(len(scene)):
        t = float(scene.times[fi])
        stem = os.path.join(save_dir, f"{name}_{fi:04d}")
        if cfg.enable_lidar:
            pred = trainer.render_pano(
                scene.poses_lidar[fi], t, scene.H_lidar, scene.W_lidar,
                scene.intrinsics_lidar, scene.intrinsics_hoz_lidar,
                use_ema=True)
            raydrop = pred["raydrop"]
            if cfg.raydrop_loss == "bce":
                raydrop = 1.0 / (1.0 + np.exp(-raydrop))
            if use_refine and trainer.has_unet:
                raydrop = trainer.refine_raydrop_pano(
                    raydrop, pred["intensity"], pred["depth"])
            mask = (raydrop > cfg.raydrop_thres).astype(np.float32)
            depth = pred["depth"] * mask
            inten = pred["intensity"] * mask
            frames["depth"].append(_to_u8(depth))
            write_png(f"{stem}_depth.png", frames["depth"][-1])
            write_png(f"{stem}_intensity.png", _to_u8(inten, vmax=1.0))
            pts = convert.pano_to_lidar_with_intensities(
                depth / cfg.scale, inten, scene.intrinsics_lidar,
                scene.intrinsics_hoz_lidar)
            np.savetxt(f"{stem}_pcd_lidar.txt", pts, fmt="%.6f")
            write_pcd(f"{stem}_lidar.pcd", pts[:, :3], pts[:, 3])
            pose = np.array(scene.poses_lidar[fi], np.float64)
            pose[:3, 3] = pose[:3, 3] / cfg.scale + np.asarray(cfg.offset)
            pw = (pose @ np.column_stack(
                [pts[:, :3], np.ones(len(pts))]).T).T[:, :3]
            np.savetxt(f"{stem}_pcd_world.txt",
                       np.column_stack([pw, pts[:, 3]]), fmt="%.6f")
        if cfg.enable_rgb and scene.poses is not None:
            out = trainer.render_view(scene.poses[fi], t, scene.H, scene.W,
                                      scene.intrinsics, use_ema=True)
            frames["rgb"].append(_to_u8(out["rgb"], vmax=1.0))
            write_png(f"{stem}_rgb.png", frames["rgb"][-1])
    if write_video:
        for kind, fr in frames.items():
            if fr:
                path = os.path.join(save_dir, f"{name}_{kind}.gif")
                write_gif(path, fr)
                if log_fn:
                    log_fn(f"[test] wrote {path}")
    if log_fn:
        log_fn(f"[test] wrote {len(scene)} frames to {save_dir}")
