"""Shared helpers of the benchmark's CPU tests: a cell's configuration cut
to a size the CPU runs in seconds (every width cut; the cells themselves
run at the configuration's own sizes on the card), and one run of it."""

from __future__ import annotations

import copy
import time

import pytest

from perfbench import harness
from perfbench import run as runmod


def tiny_config(cfg: dict, f32: bool = False) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["scene"].update(num_frames=8, lidar_hw=[8, 32], camera_hw=[8, 16],
                        camera_K=[6.3, 6.3, 8.0, 4.0])
    n = cfg["nvsf"]
    n.update(log2_hashmap_size=10, hash_size_dynamic=[9, 8, 8],
             flow_log2_hashmap_size=10, num_rays=32, num_rays_lidar=32,
             num_steps=64, occ_grid_size=16, max_ray_batch=64, stream_slab=8,
             base_resolution=16, max_resolution=128, min_resolution=4,
             flow_base_resolution=8, flow_max_resolution=64)
    if n["render_mode"] == "occupancy":
        n.update(num_steps_occ=16, num_steps_occ_rgb=16,
                 num_steps_occ_render=16)
    else:
        n.update(remat_chunks=2)
    if f32:
        n["fp16"] = False
    return cfg


# a cell the harness runs that BENCHMARK.json does not list (yet): the
# LiDAR frame render, with limits that only a tiny float32 run meets
UNLISTED = {"render-lidar.kitti360-1908-occ": (
    {"name": "render-lidar.kitti360-1908-occ", "config": "kitti360-1908-occ",
     "traffic": "lidar-frames", "chips": 1},
    {"depth_gap_m": 1e-3, "raydrop_gap": 1e-4, "intensity_gap": 1e-4})}


def cell_and_limits(man: dict, workload: str):
    if workload in UNLISTED:
        return UNLISTED[workload]
    return harness.cell(man, workload), harness.limits_file(workload)


def tiny_run(workload: str, seed: int = 2 ** 31 + 11, trace: bool = False,
             f32: bool = True, seconds: float = 0.3):
    """(result object, the Run) of one tiny CPU run of ``workload``, the
    program in float32 by default: there the reference follows it to
    rounding, so a run is correct under any limit and a planted fault
    shows alone (the limits are read on the card, at the configuration's
    own sizes and precision)."""
    man = harness.manifest()
    cell, limits = cell_and_limits(man, workload)
    cfg = tiny_config(harness.config_file(man, cell["config"]), f32)
    mix = harness.traffic_file(cell["traffic"])
    captured = {}
    orig = harness.Run.release

    def release(self):
        captured["run"] = self
        return orig(self)
    harness.Run.release = release
    try:
        res = runmod.execute(cfg, mix, limits,
                             harness.cell_metrics(man, workload, "end_to_end"),
                             harness.cell_metrics(man, workload, "per_layer"),
                             seed, seconds, trace, "cpu", 1,
                             time.perf_counter())
    finally:
        harness.Run.release = orig
    return res, captured["run"]


@pytest.fixture
def card():
    """Skips where there is no CUDA card; decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")
