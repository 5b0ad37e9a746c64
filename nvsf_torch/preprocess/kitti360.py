"""KITTI-360 preprocessing: calibration/pose chains, range-view generation,
transforms-json export, scene-bound calculation and the config writer (the
port's copy of ``nvsf_tpu/preprocess/kitti360.py``; its 3D-box parser is
``nvsf_torch.data.kitti360.load_3d_annotations``).

Rebuilds the reference's preprocessing layer
(``nvsf/preprocess/kitti360_loader.py``, ``generate_rangeview.py``,
``kitti360_to_nerf.py``, ``cal_centerpose_bound.py``) without its camtools /
kitti360Scripts dependencies. Directory layout and output schemas are
identical, so preprocessed data is interchangeable with the reference and
with the JAX package's. Range views come from the native host helper
(``nvsf_torch/native``), which reads each velodyne ``.bin`` and projects
it in one pass; the image size comes from the first camera PNG's header.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from nvsf_torch.data.kitti360 import load_3d_annotations  # noqa: F401
from nvsf_torch.lib import convert
from nvsf_torch.lib.image import png_size
from nvsf_torch.native import binding as native

# per-sequence frame ranges + validation frames
# (``kitti360_to_nerf.py:48-90``)
SEQUENCE_SPLITS = {
    "1538": (1538, 1601, [1551, 1564, 1577, 1590]),
    "1728": (1728, 1791, [1741, 1754, 1767, 1780]),
    "1908": (1908, 1971, [1921, 1934, 1947, 1960]),
    "3353": (3353, 3416, [3366, 3379, 3392, 3405]),
    "2350": (2350, 2400, [2360, 2370, 2380, 2390]),
    "4950": (4950, 5000, [4960, 4970, 4980, 4990]),
    "8120": (8120, 8170, [8130, 8140, 8150, 8160]),
    "10200": (10200, 10250, [10210, 10220, 10230, 10240]),
    "10750": (10750, 10800, [10760, 10770, 10780, 10790]),
    "11400": (11400, 11450, [11410, 11420, 11430, 11440]),
}

# KITTI HDL-64E pano geometry (``scripts/preprocess_data.py:19-31``)
KITTI_LIDAR_H = 66
KITTI_LIDAR_W = 1030
KITTI_INTRINSICS = (2.0, 26.9)          # vertical (fov_up, fov) degrees
KITTI_INTRINSICS_HOZ = (180.0, 360.0)   # horizontal
KITTI_MAX_DEPTH = 80.0


def _pad_0001(m34: np.ndarray) -> np.ndarray:
    out = np.eye(4)
    out[:3, :4] = m34
    return out


def read_calib_matrix(path, name: str, rows: int,
                      cols: int) -> Optional[np.ndarray]:
    """Read 'name: v0 v1 ...' from a KITTI-360 calibration text file."""
    with open(path) as f:
        for line in f:
            if line.startswith(name):
                vals = [float(x) for x in
                        line.replace(f"{name}:", "").split()]
                assert len(vals) == rows * cols, (name, len(vals))
                return np.array(vals).reshape(rows, cols)
    return None


class KITTI360Calibration:
    """Pose/calibration chains for one recording.

    cam2world(rectified) = imu2world @ cam2imu @ inv(R_rect);
    velo2world = imu2world @ cam00_2imu @ inv(cam00_2velo)
    (``kitti360_loader.py:144-343``). Missing poses forward-fill.
    """

    def __init__(self, root):
        self.root = Path(root)
        calib = self.root / "calibration"
        self.P_rect = {}
        self.R_rect = {}
        for cam in ("00", "01"):
            self.P_rect[cam] = read_calib_matrix(
                calib / "perspective.txt", f"P_rect_{cam}", 3, 4)
            self.R_rect[cam] = read_calib_matrix(
                calib / "perspective.txt", f"R_rect_{cam}", 3, 3)
        self.cam2imu = {}
        for cam in ("00", "01"):
            m = read_calib_matrix(calib / "calib_cam_to_pose.txt",
                                  f"image_{cam}", 3, 4)
            self.cam2imu[cam] = _pad_0001(m)
        with open(calib / "calib_cam_to_velo.txt") as f:
            vals = [float(x) for x in f.readline().split()]
        self.cam00_2velo = _pad_0001(np.array(vals).reshape(3, 4))

    def intrinsics(self, cam="00") -> np.ndarray:
        return self.P_rect[cam][:3, :3]

    def _imu2world(self, recording: str) -> Dict[int, np.ndarray]:
        poses_path = self.root / "data_poses" / f"{recording}_sync" \
            / "poses.txt"
        out = {}
        for line in np.loadtxt(poses_path).reshape(-1, 13):
            out[int(line[0])] = line[1:].reshape(3, 4)
        return out

    def cam_to_world(self, recording: str, frame_ids, cam="00") -> np.ndarray:
        imu2world = self._imu2world(recording)
        R_rect4 = np.eye(4)
        R_rect4[:3, :3] = self.R_rect[cam]
        out, last = [], None
        known = {fid: _pad_0001(m @ self.cam2imu[cam])
                 @ np.linalg.inv(R_rect4)
                 for fid, m in imu2world.items()}
        for fid in frame_ids:
            if fid in known:
                last = known[fid]
            out.append(last)
        return np.stack(out)

    def velo_to_world(self, recording: str, frame_ids) -> np.ndarray:
        imu2world = self._imu2world(recording)
        inv_c2v = np.linalg.inv(self.cam00_2velo)
        known = {fid: _pad_0001(m @ self.cam2imu["00"]) @ inv_c2v
                 for fid, m in imu2world.items()}
        out, last = [], None
        for fid in frame_ids:
            if fid in known:
                last = known[fid]
            out.append(last)
        return np.stack(out)

    def verify_against_gt(self, recording: str) -> bool:
        """Cross-check rectified cam00 poses against KITTI-360's
        cam0_to_world.txt when present (``kitti360_loader.py:216-228``)."""
        gt_path = self.root / "data_poses" / f"{recording}_sync" \
            / "cam0_to_world.txt"
        if not gt_path.exists():
            return True
        gt = {int(l[0]): l[1:].reshape(4, 4)
              for l in np.loadtxt(gt_path).reshape(-1, 17)}
        fids = sorted(gt)
        ours = self.cam_to_world(recording, fids, cam="00")
        return all(np.allclose(ours[i], gt[f], atol=1e-5)
                   for i, f in enumerate(fids))


# ----------------------------------------------------------------------
# range views (``generate_rangeview.py:185-314``)
# ----------------------------------------------------------------------

def read_velodyne_bin(path) -> np.ndarray:
    """Raw KITTI .bin -> (N, 4) [x, y, z, intensity] float32."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def lidar_to_rangeview(points_with_intensity: np.ndarray,
                       H=KITTI_LIDAR_H, W=KITTI_LIDAR_W,
                       intrinsics=KITTI_INTRINSICS,
                       intrinsics_hoz=KITTI_INTRINSICS_HOZ,
                       max_depth=KITTI_MAX_DEPTH) -> np.ndarray:
    """(N, 4) points -> (H, W, 3) [zeros, intensity, depth] range view
    (``generate_rangeview.py:185-217``)."""
    pano, inten = convert.lidar_to_pano_with_intensities(
        points_with_intensity, H, W, intrinsics, intrinsics_hoz, max_depth)
    out = np.zeros((H, W, 3), np.float32)
    out[:, :, 1] = inten
    out[:, :, 2] = pano
    return out


def velodyne_path(kitti_root, recording: str, fid: int) -> Path:
    return Path(kitti_root) / "data_3d_raw" / f"{recording}_sync" \
        / "velodyne_points" / "data" / f"{fid:010d}.bin"


def bin_to_rangeview(bin_path, H=KITTI_LIDAR_H, W=KITTI_LIDAR_W,
                     intrinsics=KITTI_INTRINSICS,
                     intrinsics_hoz=KITTI_INTRINSICS_HOZ,
                     max_depth=KITTI_MAX_DEPTH) -> np.ndarray:
    """``lidar_to_rangeview(read_velodyne_bin(bin_path))`` in one pass of
    the native helper, which equals it bit for bit."""
    return native.velodyne_bin_to_rangeview(bin_path, H, W, intrinsics,
                                            intrinsics_hoz, max_depth)


def generate_rangeviews(kitti_root, out_dir, recording: str, frame_ids,
                        **pano_kwargs) -> List[Path]:
    """Raw velodyne .bin frames -> per-frame (H, W, 3) npy range views
    (``generate_rangeview.py:260-314``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for fid in frame_ids:
        rv = bin_to_rangeview(velodyne_path(kitti_root, recording, fid),
                              **pano_kwargs)
        p = out_dir / f"{fid:010d}.npy"
        np.save(p, rv)
        paths.append(p)
    return paths


# ----------------------------------------------------------------------
# transforms json (``kitti360_to_nerf.py:99-194``)
# ----------------------------------------------------------------------

def write_transforms_jsons(kitti_root, data_root, sequence_name: str,
                           recording: str = "2013_05_28_drive_0000",
                           rangeview_dir=None) -> dict:
    """Write transforms_{seq}_{train,val,test,all}.json next to the range
    views. Returns the 'all' dict."""
    kitti_root = Path(kitti_root)
    data_root = Path(data_root)
    s, e, val_ids = SEQUENCE_SPLITS[str(sequence_name)]
    frame_ids = list(range(s, e + 1))
    train_ids = [f for f in frame_ids if f not in val_ids]
    rangeview_dir = Path(rangeview_dir) if rangeview_dir \
        else data_root / "train" / str(sequence_name)

    calib = KITTI360Calibration(kitti_root)
    K = calib.intrinsics("00")
    cam2world = calib.cam_to_world(recording, frame_ids, cam="00")
    velo2world = calib.velo_to_world(recording, frame_ids)

    im_dir = kitti_root / "data_2d_raw" / f"{recording}_sync" / "image_00" \
        / "data_rect"
    im_h, im_w = 376, 1408
    for fid in frame_ids:
        p = im_dir / f"{fid:010d}.png"
        if p.exists():
            im_h, im_w = png_size(p)
            break

    rv0 = np.load(rangeview_dir / f"{frame_ids[0]:010d}.npy")
    lidar_h, lidar_w = rv0.shape[:2]

    splits = {"train": train_ids, "val": val_ids, "test": val_ids,
              "all": frame_ids}
    out_all = None
    for split, ids in splits.items():
        frames = []
        for fid in ids:
            i = fid - s
            frames.append({
                "frame_id": fid,
                "file_path": os.path.relpath(
                    im_dir / f"{fid:010d}.png", data_root),
                "transform_matrix": cam2world[i].tolist(),
                "lidar_file_path": os.path.relpath(
                    rangeview_dir / f"{fid:010d}.npy", data_root),
                "lidar2world": velo2world[i].tolist(),
            })
        d = {
            "w": im_w, "h": im_h,
            "w_lidar": lidar_w, "h_lidar": lidar_h,
            "fl_x": float(K[0, 0]), "fl_y": float(K[1, 1]),
            "cx": float(K[0, 2]), "cy": float(K[1, 2]),
            "frame_start": s, "frame_end": e,
            "num_frames": len(frame_ids),
            "num_frames_split": len(ids),
            "aabb_scale": 2,
            "frames": frames,
        }
        path = rangeview_dir / f"transforms_{sequence_name}_{split}.json"
        with open(path, "w") as f:
            json.dump(d, f, indent=2)
        if split == "all":
            out_all = d
    return out_all


# ----------------------------------------------------------------------
# scene bounds + config writer (``cal_centerpose_bound.py:12-169``)
# ----------------------------------------------------------------------

def compute_scene_bounds(rangeview_paths, lidar2worlds,
                         intrinsics=KITTI_INTRINSICS,
                         intrinsics_hoz=KITTI_INTRINSICS_HOZ,
                         bound: float = 1.0):
    """(centerpose, scale, near, far) from all frames' world point clouds."""
    near, far = 200.0, 0.0
    pts_world = []
    for path, l2w in zip(rangeview_paths, lidar2worlds):
        pano = np.load(path)
        pc = convert.pano_to_lidar(pano[:, :, 2], intrinsics, intrinsics_hoz)
        pc_h = np.concatenate([pc, np.ones((len(pc), 1))], -1)
        dis = np.linalg.norm(pc_h, axis=1)
        near = min(dis.min(), near)
        far = max(dis.max(), far)
        pts_world.append((pc_h @ np.asarray(l2w).T)[:, :3])
    pc_all = np.concatenate(pts_world)
    centerpose = [(pc_all[:, i].max() + pc_all[:, i].min()) / 2.0
                  for i in range(3)]
    centered = pc_all - centerpose
    scale = bound / max(centered[:, i].max() for i in range(3))
    return centerpose, float(scale), float(near), float(far)


def write_scene_config(config_path, *, dataset: str, sequence_name: str,
                       data_path: str, num_frames: int, intrinsics,
                       intrinsics_hoz, lidar_range: float, scale: float,
                       offset, workspace: str) -> str:
    """Write the training config txt (``cal_centerpose_bound.py:136-167``)."""
    os.makedirs(os.path.dirname(config_path) or ".", exist_ok=True)
    with open(config_path, "w") as f:
        f.write("# Scene\n")
        f.write(f"dataloader = {dataset}\n")
        f.write(f"path = {data_path}\n")
        f.write(f"sequence_id = {sequence_name}\n")
        f.write(f"num_frames = {num_frames}\n")
        f.write(f"intrinsics_lidar = {[float(v) for v in intrinsics]}\n")
        f.write(f"intrinsics_hoz_lidar = "
                f"{[float(v) for v in intrinsics_hoz]}\n")
        f.write(f"lidar_max_depth = {float(lidar_range)}\n")
        f.write(f"scale = {float(scale)}\n")
        f.write(f"offset = {[float(v) for v in offset]}\n")
        f.write("\n# For Loss function\nflow_loss\ngrad_loss\n"
                "use_error_map\nuse_refine\n")
        f.write("\n# For Rendering\nenable_lidar\nenable_rgb\n")
        f.write("\n# Training configuration\nfp16\npreload\n")
        f.write(f"workspace = {workspace}\n")
        f.write("ckpt = scratch\n")
    return config_path


# ----------------------------------------------------------------------
# top-level pipeline (``scripts/preprocess_data.py``)
# ----------------------------------------------------------------------

def preprocess_kitti360(kitti_root, data_root, sequence_name: str,
                        recording: str = "2013_05_28_drive_0000",
                        workspace: str = "log/kitti360",
                        config_dir: str = "configs", log_fn=print,
                        **pano_kwargs) -> str:
    """rangeviews -> transforms jsons -> scene bounds -> config txt.
    Returns the config path; ``log_fn`` gets each stage's wall time."""
    s, e, _ = SEQUENCE_SPLITS[str(sequence_name)]
    frame_ids = list(range(s, e + 1))
    out_dir = Path(data_root) / "train" / str(sequence_name)
    t0 = time.perf_counter()

    def took():
        nonlocal t0
        t, t0 = t0, time.perf_counter()
        return f"{t0 - t:.3f} s"

    log_fn(f"[preprocess] generating {len(frame_ids)} range views ...")
    paths = generate_rangeviews(kitti_root, out_dir, recording, frame_ids,
                                **pano_kwargs)
    log_fn(f"[preprocess] range views: {took()}; writing transforms "
           "jsons ...")
    write_transforms_jsons(kitti_root, data_root, sequence_name, recording,
                           rangeview_dir=out_dir)
    calib = KITTI360Calibration(kitti_root)
    l2w = calib.velo_to_world(recording, frame_ids)
    log_fn(f"[preprocess] transforms jsons: {took()}; computing scene "
           "bounds ...")
    centerpose, scale, near, far = compute_scene_bounds(paths, l2w)
    cfg_path = os.path.join(config_dir, f"kitti360_{sequence_name}.txt")
    write_scene_config(
        cfg_path, dataset="kitti360", sequence_name=sequence_name,
        data_path=str(data_root), num_frames=len(frame_ids),
        intrinsics=KITTI_INTRINSICS, intrinsics_hoz=KITTI_INTRINSICS_HOZ,
        lidar_range=KITTI_MAX_DEPTH, scale=scale, offset=centerpose,
        workspace=workspace)
    log_fn(f"[preprocess] scene bounds and config: {took()}; "
           f"near={near:.2f} far={far:.2f} scale={scale:.6f} "
           f"offset={np.round(centerpose, 2)}")
    return cfg_path
