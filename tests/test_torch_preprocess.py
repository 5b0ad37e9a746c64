"""The port's raw KITTI-360 path against the JAX package and OpenCV on the
CPU: the PNG decoder and the area resize against ``cv2``, the native host
helpers against the port's numpy versions and against
``nvsf_tpu.native.binding``, the ``lidar_to_pano`` leftovers of
``lib/convert.py``, the calibration chain, and the whole preprocessing of
the mini KITTI-360 tree of ``test_preprocess.py`` through both packages and
the port's CLI.

Tolerances: the PNG decoder equals ``cv2.imread`` + ``cvtColor`` exactly;
the area resize is within one unit of ``cv2.resize(INTER_AREA)`` (exact at
integer ratios); the native projection equals the numpy one within 1e-9
(as ``tests/test_native.py``; on these inputs they agree bit for bit) and
the JAX package's native build bit for bit (the same source and flags);
range views written by both packages are equal bit for bit where both ran
the native helper, and otherwise within one f32 rounding of projections
that agree to 1e-9.
"""

import json
import re
import struct
import zlib

import cv2
import numpy as np
import pytest

from nvsf_tpu.native import binding as jnative
from nvsf_tpu.preprocess import kitti360 as JK
from nvsf_torch.lib import convert as tconvert
from nvsf_torch.lib import image
from nvsf_torch.native import binding as tnative
from nvsf_torch.preprocess import kitti360 as TK

from test_preprocess import REC, S, SEQ, mini_kitti  # noqa: F401
from test_torch_models import one_torch_thread  # noqa: F401

K_L, K_HOZ, H, W = (2.0, 26.9), (180.0, 360.0), 66, 1030


# ----------------------------------------------------------------------
# PNG decoding and the area resize against OpenCV
# ----------------------------------------------------------------------

def _cv2_read(path):
    img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4
                           else cv2.COLOR_BGR2RGB)
    return img


def _test_image(h, w, channels, rng):
    """Half noise, half smooth ramps with a little noise: libpng's
    adaptive filter choice then uses all five filter types."""
    yy, xx = np.mgrid[0:h, 0:w]
    shape = (h, w, channels) if channels else (h, w)
    noise = rng.integers(0, 256, shape)
    ramp = (xx * 3 + yy * 2) % 256
    img = (ramp[..., None] if channels else ramp) + noise // 8
    img[: h // 3] = noise[: h // 3]
    return img.astype(np.uint8)


@pytest.mark.parametrize("channels", [0, 3, 4], ids=["grey", "rgb", "rgba"])
def test_read_png_matches_cv2(channels, tmp_path):
    """Images written by cv2.imwrite at compression levels 0-9, with
    libpng's adaptive filters and with each filter forced: every row
    filter type occurs, and every image decodes to cv2's pixels."""
    rng = np.random.default_rng(channels)
    img = _test_image(37, 53, channels, rng)
    seen = set()
    forced = [None, cv2.IMWRITE_PNG_FILTER_NONE, cv2.IMWRITE_PNG_FILTER_SUB,
              cv2.IMWRITE_PNG_FILTER_UP, cv2.IMWRITE_PNG_FILTER_AVG,
              cv2.IMWRITE_PNG_FILTER_PAETH]
    for level in (0, 1, 3, 6, 9):
        for filt in forced:
            p = tmp_path / f"{level}_{filt}.png"
            params = [cv2.IMWRITE_PNG_COMPRESSION, level]
            if filt is not None:
                params += [cv2.IMWRITE_PNG_FILTER, filt]
            assert cv2.imwrite(str(p), img, params)
            got, kinds = image._decode(p)
            seen |= set(kinds.tolist())
            ref = _cv2_read(p)
            assert got.dtype == np.uint8 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref, err_msg=str(p))
            np.testing.assert_array_equal(image.read_png(p), ref)
            assert image.png_size(p) == ref.shape[:2]
    assert seen == {0, 1, 2, 3, 4}, seen


def test_read_png_on_the_mini_kitti_images(mini_kitti):  # noqa: F811
    base, src, _ = mini_kitti
    paths = sorted((src / "data_2d_raw").rglob("*.png"))
    assert len(paths) == 64
    for p in paths[:8]:
        np.testing.assert_array_equal(image.read_png(p), _cv2_read(p))
        assert image.png_size(p) == (24, 32)


def _png_bytes(W, H, depth, ctype, interlace, raw):
    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                         0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("case,reason", [
    ("16bit", "bit depth 16"), ("palette", "colour type 3"),
    ("adam7", "Adam7"), ("grey_alpha", "colour type 4")])
def test_read_png_refuses_other_pngs(case, reason, tmp_path):
    p = tmp_path / f"{case}.png"
    if case == "16bit":
        cv2.imwrite(str(p), np.full((4, 5, 3), 4000, np.uint16))
    else:
        ctype = {"palette": 3, "adam7": 2, "grey_alpha": 4}[case]
        p.write_bytes(_png_bytes(5, 4, 8, ctype, int(case == "adam7"),
                                 b"\0" * 64))
    with pytest.raises(ValueError, match=re.escape(reason)) as e:
        image.read_png(p)
    assert str(p) in str(e.value)


@pytest.mark.parametrize("shape,size", [
    ((376, 1408, 3), (704, 188)), ((376, 1408, 3), (352, 94)),
    ((48, 64, 3), (32, 16)), ((60, 90), (30, 20)),
    ((376, 1408, 3), (938, 250)), ((376, 1408, 3), (985, 112)),
    ((48, 64, 3), (42, 32)), ((61, 97, 4), (67, 18))],
    ids=["x1/2", "x1/4", "x1/2-x1/3", "grey-x1/3", "x1/1.5", "x0.7-x0.3",
         "x2/3-x1/1.5", "rgba-fractional"])
def test_resize_area_matches_cv2(shape, size):
    """Within one unit of cv2's INTER_AREA, and equal at integer ratios.
    On these inputs the fractional ratios differ from cv2 in 32 of
    703,500 values (x1/1.5), 9 of 330,960 (x0.7 by x0.3), 43 of 4,032
    (x2/3 by x1/1.5) and 0 of 4,824 (RGBA): cv2 sums its overlap weights
    in f32, this resize in f64, and the two round apart near halves."""
    img = np.random.default_rng(len(shape)).integers(0, 256, shape) \
        .astype(np.uint8)
    Wn, Hn = size
    ref = cv2.resize(img, (Wn, Hn), interpolation=cv2.INTER_AREA)
    got = image.resize_area(img, Wn, Hn)
    assert got.shape == ref.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - ref.astype(int))
    assert diff.max() <= 1, diff.max()
    if shape[1] % Wn == 0 and shape[0] % Hn == 0:
        assert diff.max() == 0
    else:
        assert (diff > 0).mean() < 0.02, (diff > 0).sum()


# ----------------------------------------------------------------------
# the native host helpers and the convert leftovers
# ----------------------------------------------------------------------

def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    r = rng.uniform(2, 70, n)
    az = rng.uniform(-np.pi, np.pi, n)
    incl = rng.uniform(np.radians(2.0 - 26.9), np.radians(2.0), n)
    return np.stack([r * np.cos(incl) * np.cos(az),
                     r * np.cos(incl) * np.sin(az), r * np.sin(incl),
                     rng.uniform(0, 1, n)], 1)


def _jax_native():
    """nvsf_tpu's native build, None where it is unavailable in this
    process (its lazy build can race with other test processes)."""
    return jnative if jnative.available() else None


@pytest.mark.parametrize("n,seed", [(5000, 0), (120000, 1)])
def test_native_projection_matches_numpy_and_jax(n, seed):
    pts = _cloud(n, seed)
    got = tconvert.lidar_to_pano_with_intensities(pts, H, W, K_L, K_HOZ)
    ref = tconvert.lidar_to_pano_with_intensities_numpy(pts, H, W, K_L,
                                                        K_HOZ)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)
    assert (got[0] > 0).sum() > min(n, H * W) // 4
    jn = _jax_native()
    if jn is not None:
        for g, r in zip(got, jn.lidar_to_pano_with_intensities(
                pts, H, W, K_L, K_HOZ)):
            np.testing.assert_array_equal(g, r)


def test_native_pano_to_lidar_and_bin_match(tmp_path):
    pts = _cloud(2000, 2)
    pano, inten = tnative.lidar_to_pano_with_intensities(pts, H, W, K_L,
                                                         K_HOZ)
    back = tnative.pano_to_lidar_with_intensities(pano, inten, K_L, K_HOZ)
    # the numpy version takes its directions in f32
    np.testing.assert_allclose(
        back, tconvert.pano_to_lidar_with_intensities(pano, inten, K_L,
                                                      K_HOZ),
        rtol=1e-4, atol=1e-4)
    p = tmp_path / "scan.bin"
    pts.astype(np.float32).tofile(p)
    rv = TK.bin_to_rangeview(p)
    ref = TK.lidar_to_rangeview(TK.read_velodyne_bin(p))
    np.testing.assert_array_equal(rv, ref)
    pano_np, inten_np = tconvert.lidar_to_pano_with_intensities_numpy(
        TK.read_velodyne_bin(p), H, W, K_L, K_HOZ)
    np.testing.assert_allclose(rv[:, :, 2], pano_np, rtol=2**-23, atol=1e-9)
    np.testing.assert_allclose(rv[:, :, 1], inten_np, rtol=2**-23,
                               atol=1e-9)
    jn = _jax_native()
    if jn is not None:
        np.testing.assert_array_equal(
            rv, jn.velodyne_bin_to_rangeview(p, H, W, K_L, K_HOZ))
        np.testing.assert_array_equal(
            back, jn.pano_to_lidar_with_intensities(pano, inten, K_L,
                                                    K_HOZ))


def test_native_build_failure_raises_with_compiler_output(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("extern \"C\" int f( { return 0; }\n")
    monkeypatch.setattr(tnative, "SRC", bad)
    monkeypatch.setattr(tnative, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building the native host "
                                           "helpers failed") as e:
        tnative._build()
    assert "broken.cpp" in str(e.value)


def test_multi_return_and_bbox_projection_match_jax():
    """The cases of tests/test_convert.py:96-122 on the port, and both
    functions equal to the JAX package's on a random cloud."""
    from nvsf_tpu.lib import convert as jconvert
    d1 = tconvert.pano_direction_grid(H, W, K_L, K_HOZ)[30, 100]
    pts = np.array([list(d1 * 10.0) + [0.3], list(d1 * 25.0) + [0.7],
                    list(d1 * 40.0) + [0.9]])
    pano, inten = tconvert.lidar_to_pano_multi_return(pts, H, W, K_L, K_HOZ,
                                                      n_returns=2)
    assert pano.shape == (2, H, W)
    np.testing.assert_allclose(pano[:, 30, 100], [10.0, 25.0], rtol=1e-6)
    np.testing.assert_allclose(inten[:, 30, 100], [0.3, 0.7])

    cloud = _cloud(20000, 5)
    bbox = [[-20, -20, -10], [20, 20, 10]]
    pano_m, _ = tconvert.lidar_to_pano_with_intensities_with_bbox_mask(
        cloud, bbox, H, W, K_L, K_HOZ)
    pano_f, _ = tconvert.lidar_to_pano_with_intensities(cloud, H, W, K_L,
                                                        K_HOZ)
    assert (pano_m > 0).sum() < (pano_f > 0).sum()
    assert pano_m.max() <= np.sqrt(20**2 + 20**2 + 10**2) + 1e-6
    for got, ref in [
            (tconvert.lidar_to_pano_multi_return(cloud, H, W, K_L, K_HOZ,
                                                 n_returns=3),
             jconvert.lidar_to_pano_multi_return(cloud, H, W, K_L, K_HOZ,
                                                 n_returns=3)),
            ((pano_m,), jconvert.lidar_to_pano_with_intensities_with_bbox_mask(
                cloud, bbox, H, W, K_L, K_HOZ)[:1])]:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-9)


# ----------------------------------------------------------------------
# calibration and the whole preprocessing against the JAX package
# ----------------------------------------------------------------------

def test_calibration_chain_matches_jax(mini_kitti):  # noqa: F811
    base, src, K_mat = mini_kitti
    calib, jcalib = TK.KITTI360Calibration(src), JK.KITTI360Calibration(src)
    np.testing.assert_allclose(calib.intrinsics("00"), K_mat)
    fids = list(range(S, S + 64))
    c2w = calib.cam_to_world(REC, fids)
    v2w = calib.velo_to_world(REC, fids)
    assert c2w.shape == (64, 4, 4)
    np.testing.assert_allclose(c2w[5], c2w[4])       # a missing pose
    assert np.isfinite(v2w).all()
    assert calib.verify_against_gt(REC)              # no GT file
    np.testing.assert_array_equal(c2w, jcalib.cam_to_world(REC, fids))
    np.testing.assert_array_equal(v2w, jcalib.velo_to_world(REC, fids))
    for cam in ("00", "01"):
        np.testing.assert_array_equal(calib.P_rect[cam], jcalib.P_rect[cam])
        np.testing.assert_array_equal(calib.cam2imu[cam],
                                      jcalib.cam2imu[cam])
    # a GT file that agrees, then one that does not
    gt = src / "data_poses" / f"{REC}_sync" / "cam0_to_world.txt"
    rows = [[f] + list(c2w[i].reshape(-1)) for i, f in enumerate(fids[:6])]
    try:
        np.savetxt(gt, rows)
        assert calib.verify_against_gt(REC)
        rows[2][4] += 0.01
        np.savetxt(gt, rows)
        assert not calib.verify_against_gt(REC)
        assert not jcalib.verify_against_gt(REC)
    finally:
        gt.unlink()


def _config_lines(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith(("path =", "workspace ="))]


def _config_value(lines, key):
    return next(ln.split("=", 1)[1].strip() for ln in lines
                if ln.startswith(key + " ="))


def test_preprocess_matches_jax(mini_kitti, tmp_path):  # noqa: F811
    """Both packages' preprocess_kitti360 at the HDL-64E pano size, into
    two data roots side by side: range views, the transforms jsons, the
    config text but its paths, and near / far / scale / offset. Which
    range-view case held is printed (bit for bit when the JAX package's
    native helper was built in this process)."""
    base, src, _ = mini_kitti
    logs = {"jax": [], "port": []}
    cfgs = {}
    for name, mod in (("jax", JK), ("port", TK)):
        cfgs[name] = mod.preprocess_kitti360(
            src, tmp_path / name, SEQ, recording=REC,
            config_dir=str(tmp_path / f"configs_{name}"),
            workspace=str(tmp_path / f"log_{name}"),
            log_fn=logs[name].append)
    dj, dt = (tmp_path / n / "train" / SEQ for n in ("jax", "port"))
    npys = sorted(p.name for p in dj.glob("*.npy"))
    assert len(npys) == 64 and npys == sorted(p.name
                                              for p in dt.glob("*.npy"))
    bitwise = _jax_native() is not None
    for n in npys:
        a, b = np.load(dt / n), np.load(dj / n)
        assert a.shape == (H, W, 3) and a.dtype == b.dtype == np.float32
        if bitwise:
            np.testing.assert_array_equal(a, b, err_msg=n)
        else:
            np.testing.assert_allclose(a, b, rtol=2**-23, atol=1e-9,
                                       err_msg=n)
    print("range views: " + ("bit for bit (both native)" if bitwise
                              else "within f32 rounding (JAX numpy)"))
    jsons = sorted(p.name for p in dj.glob("transforms_*.json"))
    assert len(jsons) == 4
    for n in jsons:
        assert json.loads((dt / n).read_text()) \
            == json.loads((dj / n).read_text()), n
    tj = json.loads((dt / f"transforms_{SEQ}_all.json").read_text())
    assert (tj["h"], tj["w"]) == (24, 32)            # png_size
    lt, lj = _config_lines(cfgs["port"]), _config_lines(cfgs["jax"])
    assert lt == lj
    for key in ("scale", "offset", "lidar_max_depth"):
        assert _config_value(lt, key) == _config_value(lj, key)
    near_far = [re.search(r"near=\S+ far=\S+ scale=\S+ offset=.*$",
                          logs[n][-1]).group(0) for n in ("port", "jax")]
    assert near_far[0] == near_far[1], near_far
    assert "range views:" in logs["port"][1]          # stage times


def test_preprocess_cli_argv(mini_kitti, tmp_path, capsys):  # noqa: F811
    """The port's CLI takes the JAX CLI's options and drives the same
    pipeline: the config it writes matches the JAX package's function on
    the same tree but for its paths."""
    from nvsf_torch.scripts.preprocess_data import main as pp_main

    def options(main):
        with pytest.raises(SystemExit):
            main(["--help"])
        return sorted(set(re.findall(r"--\w+", capsys.readouterr().out)))

    from nvsf_tpu.scripts.preprocess_data import main as jax_main
    assert options(pp_main) == options(jax_main)
    base, src, _ = mini_kitti
    pp_main(["--dataset", "kitti360", "--sequence_name", SEQ,
             "--recording", REC, "--kitti_root", str(src),
             "--data_root", str(tmp_path / "data"),
             "--config_dir", str(tmp_path / "configs"),
             "--workspace", str(tmp_path / "log")])
    out = capsys.readouterr().out
    cfg_path = tmp_path / "configs" / f"kitti360_{SEQ}.txt"
    assert f"--config {cfg_path}" in out
    ref = JK.preprocess_kitti360(
        src, tmp_path / "jdata", SEQ, recording=REC,
        config_dir=str(tmp_path / "jconfigs"),
        workspace=str(tmp_path / "jlog"), log_fn=lambda *a: None)
    lines = _config_lines(cfg_path)
    assert _config_value(lines, "sequence_id") == SEQ
    assert lines == _config_lines(ref)
    assert np.load(tmp_path / "data" / "train" / SEQ
                   / f"{S:010d}.npy").shape == (H, W, 3)
