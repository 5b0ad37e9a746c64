"""Scene data held as host numpy arrays (counterpart of ``SceneData`` in
``nvsf_tpu/data/dataset.py``, which cannot be imported without JAX). The
trainer moves the arrays to its device once."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


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
