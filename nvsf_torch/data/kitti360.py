"""KITTI-360 scenes: a preprocessed sequence split and its 3D box
annotations (counterpart of ``nvsf_tpu/data/kitti360.py``, with the port's
copy of ``load_3d_annotations`` from ``nvsf_tpu/preprocess/kitti360.py``;
the raw-data preprocessing is ``nvsf_torch/preprocess/kitti360.py``)."""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Optional

import numpy as np

from nvsf_torch.data.dataset import SceneData, load_scene


def load_3d_annotations(kitti_root, recording: str, frame_ids) -> list:
    """Parse the KITTI-360 train_full 3D box XML into per-frame lists of
    {vertices [8, 3] world, label, dynamic}. Objects with a start/end frame
    window go to the frames inside it; static objects to every frame."""
    kitti_root = Path(kitti_root)
    xml_path = kitti_root / "data_3d_bboxes" / "train_full" \
        / f"{recording}_sync.xml"
    if not xml_path.exists():
        xml_path = kitti_root / "data_3d_bboxes" / "train" \
            / f"{recording}_sync.xml"
    per_frame = {fid: [] for fid in frame_ids}
    if not xml_path.exists():
        return [per_frame[f] for f in frame_ids]

    def _mat(node):
        rows = int(node.find("rows").text)
        cols = int(node.find("cols").text)
        vals = [float(x) for x in node.find("data").text.split()]
        return np.array(vals).reshape(rows, cols)

    root = ET.parse(xml_path).getroot()
    for obj in root:
        tr = obj.find("transform")
        verts = obj.find("vertices")
        if tr is None or verts is None:
            continue
        T = _mat(tr)
        V = _mat(verts)
        vert_world = (T[:3, :3] @ V.T).T + T[:3, 3]
        label_node = obj.find("label")
        label = label_node.text if label_node is not None else obj.tag
        sf = obj.find("start_frame")
        ef = obj.find("end_frame")
        start = int(sf.text) if sf is not None else -1
        end = int(ef.text) if ef is not None else -1
        ts = obj.find("timestamp")
        timestamp = int(ts.text) if ts is not None else -1
        dynamic = timestamp > 0
        for fid in frame_ids:
            if dynamic and timestamp != fid:
                continue
            if start >= 0 and end >= 0 and not (start <= fid <= end):
                continue
            # the box's 8 corners are its first 8 vertices
            per_frame[fid].append({"vertices": vert_world[:8],
                                   "label": label, "dynamic": dynamic})
    return [per_frame[f] for f in frame_ids]


def load_kitti360_scene(cfg, split: str, novel_sensor: Optional[dict] = None
                        ) -> SceneData:
    """One KITTI-360 sequence split as SceneData, with its 3D annotations
    when the raw source tree is present (``kitti360_dataset.py:51-79``)."""
    scene = load_scene(
        cfg.path, str(cfg.sequence_id), split,
        scale=cfg.scale, offset=cfg.offset,
        enable_lidar=cfg.enable_lidar, enable_rgb=cfg.enable_rgb,
        intrinsics_lidar=cfg.intrinsics_lidar,
        intrinsics_hoz_lidar=cfg.intrinsics_hoz_lidar,
        novel_sensor=novel_sensor)
    source = os.path.join(cfg.path, "source_data")
    if os.path.isdir(source):
        recording = "2013_05_28_drive_0000"
        fids = [int(f) for f in scene.frame_ids]
        scene.annotations = load_3d_annotations(source, recording, fids)
    return scene
