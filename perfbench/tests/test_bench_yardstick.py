"""The benchmark's FLOP and byte arithmetic on hand-counted tiny shapes, and
the scene generator's determinism."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import scene as scenes
from perfbench import yardstick as ys
from perfbench.tests.conftest import tiny_config
from perfbench import harness


def test_kernel_bytes_and_ops():
    # segment-add: M cols (4 B) + F*M values (4 B) read, F*T written
    assert ys.segment_add(2, 10, 5) == ("segment_add",
                                        4 * 10 + 4 * 20 + 4 * 10, 20)
    # multihot forward: F=2, Q=1, S=3, C=4, W=8, Np=5
    # tables 2*1*3*8 floats, cols + ws 1*3*4*5 each, out 1*3*2*5
    name, b, o = ys.multihot_fwd(2, 1, 3, 4, 8, 5)
    assert b == 4 * 48 + 8 * 60 + 4 * 30 and o == 2 * 60 * 2
    name, b, o = ys.multihot_bwd(2, 1, 3, 4, 8, 5, False)
    assert b == 8 * 60 + 4 * 30 + 4 * 48 and o == 2 * 60 * 2
    name, b2, o2 = ys.multihot_bwd(2, 1, 3, 4, 8, 5, True)
    assert b2 == b + 4 * 48 + 4 * 60 and o2 == 2 * o


def test_bound_takes_the_larger():
    assert ys.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert ys.bound_s(0, 67e12) == pytest.approx(1.0)
    assert ys.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def _cfg(**over):
    c = {"n_levels_hash": 1, "n_features_per_level_hash": 4,
         "flow_n_levels": 1, "flow_n_features_per_level": 4,
         "n_features_per_level_plane": 1, "n_levels_plane": 1,
         "geo_feat_dim": 1, "hidden_dim_sigma": 2, "num_layers_sigma": 2,
         "hidden_dim_flow": 2, "num_layers_flow": 2, "hidden_dim_lidar": 2,
         "hidden_dim_color": 2, "num_layers_color": 2}
    c.update(over)
    return c


def test_point_flops_hand_counted():
    c = _cfg()
    # sigma in = 2*1*1 planes + 1*4 static hash + 3*1*4/4 dynamic = 9
    d = ys.mlp_dims(c)
    assert d["sigma"] == [9, 2, 2] and d["flow"] == [1, 2, 6]
    assert d["lidar_head"] == [73, 2, 1] and d["color"] == [17, 2, 3]
    mlp = lambda dims: sum(2 * a * b for a, b in zip(dims, dims[1:]))  # noqa
    enc_nowarp = 2 * 8 * 4 + 2 * 3 * 4 * 1 + 2 * 3 * 4 * 1 + 2 * 3 * 4 * 1
    assert ys.point_flops(c, False, warp=False) == \
        enc_nowarp + mlp([9, 2, 2]) + mlp([17, 2, 3])
    enc_warp = 2 * 8 * 4 + 3 * 2 * 3 * 4 * 1 + 2 * 3 * 4 + 3 * 2 * 3 * 4
    assert ys.point_flops(c, True) == enc_warp + mlp([9, 2, 2]) \
        + 2 * 8 * 1 + mlp([1, 2, 6]) + 2 * mlp([73, 2, 1])


def test_step_flops_and_calls_scale_with_samples():
    man = harness.manifest()
    cfg = harness.run_config(tiny_config(harness.config_file(
        man, "kitti360-1908-occ")))
    nl, nc = ys.samples_per_step(cfg)
    assert (nl, nc) == (32 * 16, 32 * 16)
    assert ys.step_flops(cfg) == pytest.approx(
        3 * (nl * ys.point_flops(cfg, True) + nc * ys.point_flops(cfg, False)))
    calls = ys.step_calls(cfg, 0)
    kinds = [k for k, _, _ in calls]
    # per branch: 2 forwards, 2 backwards, 3 table gradients
    assert kinds.count("multihot_fwd") == 4
    assert kinds.count("multihot_bwd") == 4
    assert kinds.count("segment_add") == 6
    dense = harness.run_config(tiny_config(harness.config_file(
        man, "kitti360-1908-ref")))
    kinds = [k for k, _, _ in ys.step_calls(dense, 0)]
    # two remat chunks a branch: each forward again in the backward
    assert kinds.count("multihot_fwd") == 2 * 2 * 2 * 2
    assert ys.frame_slabs(cfg, 8 * 32) == 4 * 2


def test_scene_is_deterministic_for_a_seed():
    man = harness.manifest()
    spec = tiny_config(harness.config_file(man, "kitti360-1908-occ"))["scene"]
    a = scenes.make_scene(spec, 7, "cpu")
    b = scenes.make_scene(spec, 7, "cpu")
    c = scenes.make_scene(spec, 8, "cpu")
    for k in ("panos", "images", "poses_lidar", "poses"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["panos"], c["panos"])
    assert a["panos"].shape == (8, 8, 32, 3)
    assert a["images"].shape == (8, 8, 16, 3)
    hit = a["panos"][..., 0] > 0
    assert hit.any() and (a["panos"][..., 2][hit] > 0).all()
    assert torch.tensor(a["panos"]).isfinite().all()


def test_returns_grid_holds_every_return_and_no_more():
    """The render mix's grid: each LiDAR return of the scene lies in an
    occupied cell, the rest of the box is empty, the same for a seed."""
    from perfbench.reference import model as M
    man = harness.manifest()
    cfg = tiny_config(harness.config_file(man, "kitti360-1908-occ"))
    c = harness.run_config(cfg)
    scene = scenes.make_scene(cfg["scene"], 7, "cpu")
    grid = scenes.returns_grid(c, scene, 32.0, "cpu")
    assert torch.equal(grid, scenes.returns_grid(c, scene, 32.0, "cpu"))
    assert set(torch.unique(grid).tolist()) == {0.0, 32.0}
    Hl, Wl = scene["panos"].shape[1:3]
    inds = torch.arange(Hl * Wl)
    for fi in (0, len(scene["times"]) - 1):
        pano = torch.as_tensor(scene["panos"][fi])
        ro, rd = M.to_world(torch.as_tensor(scene["poses_lidar"][fi]),
                            M.lidar_dirs(inds, Hl, Wl,
                                         scene["intrinsics_lidar"],
                                         scene["intrinsics_hoz_lidar"]))
        hit = pano[..., 0].reshape(-1) > 0
        xyz = (ro + rd * pano[..., 2].reshape(-1, 1))[hit]
        assert M.occupied(c, grid, xyz).all()
    assert 0 < (grid > 0).float().mean() < 0.5
