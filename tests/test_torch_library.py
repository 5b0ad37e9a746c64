"""The port's library leftovers against the JAX package on the CPU: the pose
helpers, the IO and geometry helpers of ``lib/tools.py``, the
``mape_loss`` and ``eff_distortion_loss`` of the loss library, and the GIF
writer behind test mode's videos (decoded with PIL).

Tolerances: the numpy helpers run the same float64 arithmetic as the JAX
package's and must agree to 1e-12; the losses run in f32 in both
frameworks (rtol 1e-6); a GIF decodes to its frames exactly (grey
frames) or to the frames' 3-3-2 palette colours (RGB frames).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from nvsf_tpu.lib import pose as jpose
from nvsf_tpu.lib import tools as jtools
from nvsf_tpu.train import losses as jlosses
from nvsf_torch.lib import image, pose as tpose, tools as ttools
from nvsf_torch.train import losses as tlosses

from test_torch_models import one_torch_thread  # noqa: F401


def _rotations(rng):
    """Random rotations, and the half turns that take the trace <= 0
    branches of matrix_to_quaternion."""
    rs = [np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(6)]
    rs = [r * np.sign(np.linalg.det(r)) for r in rs]
    return rs + [np.diag(d) for d in ([1, -1, -1], [-1, 1, -1],
                                      [-1, -1, 1])]


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(0)
    for R in _rotations(rng):
        q = tpose.matrix_to_quaternion(R)
        np.testing.assert_allclose(q, jpose.matrix_to_quaternion(R),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(tpose.quaternion_to_matrix(q), R,
                                   atol=1e-12)
        q2 = rng.standard_normal(4) * 3
        np.testing.assert_allclose(tpose.quaternion_to_matrix(q2),
                                   jpose.quaternion_to_matrix(q2),
                                   rtol=0, atol=1e-12)
        pos, size = rng.uniform(-5, 5, 3), rng.uniform(0.5, 4, 3)
        corners = tpose.bbox_corners(pos, size, q)
        np.testing.assert_allclose(corners, jpose.bbox_corners(pos, size, q),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(corners.mean(0), pos, atol=1e-12)
    np.testing.assert_array_equal(tpose.quaternion_to_matrix([0, 0, 0, 0]),
                                  np.eye(3))
    assert ttools.bbox_corners is tpose.bbox_corners


def test_io_helpers_read_each_others_files(tmp_path):
    """JSON, CSV and the flat YAML reader: each package reads what the
    other wrote; dict_to_cls nests."""
    data = {"a": 1, "b": [1.5, 2.0], "c": {"d": "x"},
            "e": np.float32(0.25)}
    for write, read in ((ttools.write_json, jtools.read_json),
                        (jtools.write_json, ttools.read_json)):
        p = tmp_path / "sub" / f"{write.__module__}.json"
        write(str(p), data)
        assert read(str(p)) == {"a": 1, "b": [1.5, 2.0], "c": {"d": "x"},
                                "e": 0.25}
    rows = [["frame", "cd"], ["1", "0.5"], ["2", "a,b"]]
    for write, read in ((ttools.write_csv, jtools.read_csv),
                        (jtools.write_csv, ttools.read_csv)):
        p = tmp_path / "csv" / f"{write.__module__}.csv"
        write(str(p), rows)
        assert read(str(p)) == rows
    y = tmp_path / "cfg.yaml"
    y.write_text("# scene\nname: kitti  # a comment\nscale: 0.01\n\n"
                 "path: a:b\n")
    assert ttools.read_yaml(str(y)) == jtools.read_yaml(str(y)) \
        == {"name": "kitti", "scale": "0.01", "path": "a:b"}
    ns = ttools.dict_to_cls(a=1, b={"c": {"d": 2}})
    assert ns.a == 1 and ns.b.c.d == 2
    assert vars(ns.b.c) == vars(jtools.dict_to_cls(a=1, b={"c": {"d": 2}})
                                .b.c)


def test_geometry_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    hull = np.array([[x, y, z] for x in (-1, 1) for y in (-2, 2)
                     for z in (0, 1)], float)
    pts = rng.uniform(-3, 3, (500, 3))
    got = ttools.check_in_hull(pts, hull)
    for g, r in zip(got, jtools.check_in_hull(pts, hull)):
        np.testing.assert_array_equal(g, r)
    assert 0 < len(got[0]) < len(pts)
    pc = np.concatenate([rng.normal(0, 1, (300, 3)),
                         rng.uniform(20, 30, (5, 3))])
    for g, r in zip(ttools.filter_outliers(pc, 10, 2.0),
                    jtools.filter_outliers(pc, 10, 2.0)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))
    # tests/test_pointcloud.py::test_write_pcd on the port, then both
    # packages' files equal
    pts = np.array([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
    for mod in (ttools, jtools):
        mod.write_pcd(str(tmp_path / f"{mod.__name__}.pcd"), pts,
                      intensities=[0.5, 0.25])
    lines = (tmp_path / "nvsf_torch.lib.tools.pcd").read_text().splitlines()
    assert "FIELDS x y z intensity" in lines and "POINTS 2" in lines
    assert [float(v) for v in lines[-1].split()] == [4.0, 5.0, 6.0, 0.25]
    assert lines == (tmp_path / "nvsf_tpu.lib.tools.pcd").read_text() \
        .splitlines()


def test_mape_and_eff_distortion_match_jax():
    """tests/test_losses.py:45-63 on the port (the O(T) distortion loss
    against its O(T^2) definition, MAPE on one value), and both losses
    against the JAX package's on random inputs."""
    v = tlosses.mape_loss(torch.tensor([1.1]), torch.tensor([1.0]))
    np.testing.assert_allclose(float(v[0]), 0.1 / 1.01, rtol=1e-4)
    rng = np.random.default_rng(0)
    w = rng.uniform(0, 1, (3, 16)).astype(np.float32)
    m = np.sort(rng.uniform(0, 1, (3, 16)), axis=-1).astype(np.float32)
    eff = tlosses.eff_distortion_loss(torch.from_numpy(w),
                                      torch.from_numpy(m)).numpy()
    cross = np.einsum("ni,nj,nij->n", w, w,
                      np.abs(m[:, :, None] - m[:, None, :]))
    d = np.concatenate([m[:, 1:] - m[:, :-1], np.zeros((3, 1), np.float32)],
                       -1)
    np.testing.assert_allclose(eff, cross + (w ** 2 * d).sum(-1) / 3.0,
                               rtol=1e-4)
    np.testing.assert_allclose(
        eff, np.asarray(jlosses.eff_distortion_loss(jnp.asarray(w),
                                                    jnp.asarray(m))),
        rtol=1e-6)
    p, g = rng.uniform(-2, 2, (2, 64)).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.mape_loss(torch.from_numpy(p), torch.from_numpy(g)).numpy(),
        np.asarray(jlosses.mape_loss(jnp.asarray(p), jnp.asarray(g))),
        rtol=1e-6)


def _gif_frames(path):
    im = Image.open(path)
    frames = [np.asarray(f.convert("RGB")) for f in
              ImageSequence.Iterator(im)]
    return frames, im.info


@pytest.mark.parametrize("rgb", [False, True], ids=["grey", "rgb"])
def test_write_gif_decodes_to_its_frames(rgb, tmp_path):
    """Random frames (past the 4096-entry LZW table, so the writer clears
    it mid-frame), a flat frame and a ramp, 100 ms a frame, looping."""
    rng = np.random.default_rng(2)
    shape = (66, 300) + ((3,) if rgb else ())
    frames = [rng.integers(0, 256, shape).astype(np.uint8)
              for _ in range(2)]
    frames.append(np.zeros(shape, np.uint8))
    frames.append(np.broadcast_to((np.arange(300) % 256).astype(np.uint8)
                                  [None, :, None] if rgb else
                                  (np.arange(300) % 256).astype(np.uint8),
                                  shape).copy())
    p = tmp_path / "v.gif"
    ttools.write_gif(str(p), frames)
    got, info = _gif_frames(p)
    assert len(got) == len(frames)
    assert info["duration"] == 100 and info["loop"] == 0
    pal = ttools.gif_palette(rgb)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, pal[ttools.gif_palette_indices(f)])
        if not rgb:
            np.testing.assert_array_equal(g[..., 0], f)
    with pytest.raises(ValueError, match="one shape"):
        ttools.write_gif(str(p), [frames[0], frames[0][:5]])


def test_run_test_writes_videos(tmp_path):
    """Test mode with ``write_video``: the depth and RGB GIFs decode to the
    frames of the PNGs it wrote beside them."""
    from nvsf_torch.train.test_mode import run_test
    rng = np.random.default_rng(3)

    class Renders:
        cfg = types.SimpleNamespace(enable_lidar=True, enable_rgb=True,
                                    raydrop_loss="mse", raydrop_thres=0.5,
                                    scale=0.1, offset=[0.0, 0.0, 0.0])
        has_unet = False

        def render_pano(self, pose, t, H, W, K, K_hoz, use_ema):
            return {"depth": rng.uniform(0, 1, (H, W)),
                    "raydrop": rng.uniform(0, 1, (H, W)),
                    "intensity": rng.uniform(0, 1, (H, W))}

        def render_view(self, pose, t, H, W, K, use_ema):
            return {"rgb": rng.uniform(0, 1, (H, W, 3))}

    class Scene:
        times = np.linspace(0, 1, 3)
        poses_lidar = poses = np.tile(np.eye(4), (3, 1, 1))
        H_lidar, W_lidar, H, W = 8, 32, 6, 10
        intrinsics_lidar, intrinsics_hoz_lidar = (2.0, 26.9), (180.0, 360.0)
        intrinsics = np.eye(3)

        def __len__(self):
            return 3

    scene = Scene()
    logs = []
    run_test(Renders(), scene, save_dir=str(tmp_path), name="t",
             write_video=True, log_fn=logs.append)
    for kind in ("depth", "rgb"):
        got, info = _gif_frames(tmp_path / f"t_{kind}.gif")
        pngs = [image.read_png(tmp_path / f"t_{i:04d}_{kind}.png")
                for i in range(3)]
        assert len(got) == 3 and info["duration"] == 100
        pal = ttools.gif_palette(kind == "rgb")
        for g, f in zip(got, pngs):
            np.testing.assert_array_equal(
                g, pal[ttools.gif_palette_indices(f)])
    assert any("t_rgb.gif" in m for m in logs)
