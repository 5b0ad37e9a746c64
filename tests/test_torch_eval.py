"""The port's eval path against the JAX package on the CPU: the meters and
error matrices, the object masks, the copied numpy modules (convert,
pointcloud, config), the streaming occupancy marcher and ``evaluate``
itself on bridged state.

Tolerances: the meters and the numpy copies run the same numpy code on the
same inputs and must agree exactly, except the PointsMeter, whose chamfer
sums run in another order (see ``_b5_tol`` in test_torch_ops.py). The
renders are held to rtol 1e-4 / atol 1e-5, as the training renderer's
parity test is: f32 transcendentals and sums differ at the ulp level
between XLA and PyTorch.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu import config as jconfig
from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nvsf_tpu.lib import convert as jconvert
from nvsf_tpu.lib import masks as jmasks
from nvsf_tpu.lib import metrics as jM
from nvsf_tpu.lib import pointcloud as jpc
from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.render.renderer import RendererSpec
from nvsf_torch import bridge
from nvsf_torch import config as tconfig
from nvsf_torch.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_torch.lib import convert as tconvert
from nvsf_torch.lib import masks as tmasks
from nvsf_torch.lib import metrics as tM
from nvsf_torch.lib import pointcloud as tpc
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.render import renderer as renderer_mod
from nvsf_torch.render.renderer import Renderer

from test_torch_models import fields, one_torch_thread  # noqa: F401
from test_torch_step import _config, _shared_rays

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-4, atol=1e-5)
SPEC = dict(num_frames=4, H_lidar=16, W_lidar=48, H=16, W=24,
            max_depth=80.0, scale=1.0 / 81.0)


# ----------------------------------------------------------------------
# (c) the port's own copies of the JAX-free modules
# ----------------------------------------------------------------------

def test_config_parses_shipped_config_as_jax_does():
    path = os.path.join(REPO, "configs", "kitti360_1908.txt")
    d = tconfig.parse_config_file(path)
    assert d == jconfig.parse_config_file(path)
    t = tconfig.NVSFConfig.from_dict(d)
    j = jconfig.NVSFConfig.from_dict(d)
    assert t.to_dict() == j.to_dict()
    assert t.finalize(7).to_dict() == j.finalize(7).to_dict()
    argv = ["--config", path, "--fp16", "--num_rays", "512"]
    assert tconfig.load_config(argv).to_dict() \
        == jconfig.load_config(argv).to_dict()


def test_convert_and_pointcloud_match_jax():
    rng = np.random.default_rng(0)
    K, K_hoz = (10.0, 40.0), (180.0, 360.0)
    depth = rng.uniform(1, 60, (24, 64)) * (rng.uniform(size=(24, 64)) > 0.2)
    inten = rng.uniform(size=(24, 64))
    for fn, args in [("pano_direction_grid", (24, 64, K, K_hoz)),
                     ("pano_to_lidar", (depth, K, K_hoz)),
                     ("pano_to_lidar_with_intensities",
                      (depth, inten, K, K_hoz))]:
        np.testing.assert_array_equal(getattr(tconvert, fn)(*args),
                                      getattr(jconvert, fn)(*args), fn)
    pts = np.column_stack([tconvert.pano_to_lidar(depth, K, K_hoz),
                           inten[depth != 0]])
    for got, ref in zip(
            tconvert.lidar_to_pano_with_intensities(pts, 24, 64, K, K_hoz,
                                                    50.0),
            jconvert.lidar_to_pano_with_intensities(pts, 24, 64, K, K_hoz,
                                                    50.0)):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tconvert.lidar_to_pano(pts[:, :3], 24, 64,
                                                         K, K_hoz),
                                  jconvert.lidar_to_pano(pts[:, :3], 24, 64,
                                                         K, K_hoz))
    cloud = np.column_stack([rng.uniform(-30, 30, (2000, 2)),
                             rng.uniform(-2, 3, 2000)])
    cloud[:800, 2] = -1.7 + rng.normal(0, 0.02, 800)        # a ground plane
    for got, ref in zip(tpc.point_removal(cloud, dist_max=40.0),
                        jpc.point_removal(cloud, dist_max=40.0)):
        np.testing.assert_array_equal(got, ref)
    clouds = [cloud[:5], cloud[:0], cloud[:9]]
    for got, ref in zip(tpc.pad_pointclouds(clouds),
                        jpc.pad_pointclouds(clouds)):
        np.testing.assert_array_equal(got, ref)


def test_object_masks_match_jax():
    spec = SyntheticSceneSpec(**SPEC)
    scene = make_synthetic_scene(spec, split="val")
    ann = scene.annotations[0]
    assert ann
    kw = dict(scale=spec.scale, offset=(0.0, 0.0, 0.0),
              intrinsics_lidar=scene.intrinsics_lidar,
              intrinsics_hoz_lidar=scene.intrinsics_hoz_lidar,
              max_depth=spec.max_depth)
    depth = scene.images_lidar[0][:, :, 2]
    got = tmasks.compute_object_masks_pano(depth, scene.poses_lidar[0], ann,
                                           **kw)
    ref = jmasks.compute_object_masks_pano(depth, scene.poses_lidar[0], ann,
                                           **kw)
    assert got[1].sum() > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    got = tmasks.compute_object_masks_image(
        scene.poses[0], scene.intrinsics, ann, scene.H, scene.W,
        scale=spec.scale, offset=(0.0, 0.0, 0.0))
    ref = jmasks.compute_object_masks_image(
        scene.poses[0], scene.intrinsics, ann, scene.H, scene.W,
        scale=spec.scale, offset=(0.0, 0.0, 0.0))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


# ----------------------------------------------------------------------
# (b) the meters and the error matrices
# ----------------------------------------------------------------------

def _meter_pairs():
    """(name, port meter, JAX meter, update inputs) on the same data."""
    rng = np.random.default_rng(1)
    s = 1 / 81
    gt = rng.uniform(2, 60, (2, 1, 16, 48)) * s
    gt[..., :3, :] = 0.0                                     # dropped rays
    pred = np.clip(gt + rng.normal(0, 0.3 * s, gt.shape), 0, None)
    inten = rng.uniform(size=(2, 1, 16, 48))
    inten_p = np.clip(inten + rng.normal(0, 0.05, inten.shape), 0, 1)
    rgb = rng.uniform(size=(2, 1, 20, 24, 3))
    rgb_p = np.clip(rgb + rng.normal(0, 0.05, rgb.shape), 0, 1)
    drop = (rng.uniform(size=(2, 16, 48)) > 0.3).astype(np.float32)
    drop_p = np.clip(drop + rng.normal(0, 0.3, drop.shape), 0, 1)
    K, K_hoz = (10.0, 40.0), (180.0, 360.0)
    return [
        ("psnr", tM.PSNRMeter(), jM.PSNRMeter(), zip(rgb_p[:, 0], rgb[:, 0])),
        ("rmse", tM.RMSEMeter(rgb_metric=True),
         jM.RMSEMeter(rgb_metric=True), zip(pred / s, gt / s)),
        ("mae", tM.MAEMeter(2.0), jM.MAEMeter(2.0), zip(inten_p, inten)),
        ("ssim", tM.SSIMMeter(), jM.SSIMMeter(), zip(rgb_p, rgb)),
        ("lpips", tM.LPIPSMeter(), jM.LPIPSMeter(), zip(rgb_p[:, 0],
                                                        rgb[:, 0])),
        ("depth", tM.DepthMeter_L4D(s), jM.DepthMeter_L4D(s),
         zip(pred, gt)),
        ("intensity", tM.IntensityMeter_L4D(1.0), jM.IntensityMeter_L4D(1.0),
         zip(inten_p, inten)),
        ("raydrop", tM.RaydropMeter(0.5), jM.RaydropMeter(0.5),
         zip(drop_p, drop)),
        ("point", tM.PointsMeter(s, K, K_hoz, device="cpu"),
         jM.PointsMeter(s, K, K_hoz), zip(pred, gt)),
    ]


def test_meters_and_error_matrix_match_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("NVSF_TPU_LPIPS_WEIGHTS", raising=False)
    tm, jm = {}, {}
    for name, t, j, inputs in _meter_pairs():
        for p, g in inputs:
            t.update(p, g)
            j.update(p, g)
        got, ref = np.asarray(t.measure()), np.asarray(j.measure())
        if name == "point":   # chamfer sums in another order (B5 tolerance)
            np.testing.assert_allclose(got, ref, rtol=1e-5)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        assert t.report() == j.report() or name == "point"
        tm[name], jm[name] = t, j
    a = tM.write_error_matrix(tm, str(tmp_path / "t.json"), {"epoch": 3})
    b = jM.write_error_matrix(jm, str(tmp_path / "j.json"), {"epoch": 3})
    assert a.keys() == b.keys()
    assert json.loads((tmp_path / "t.json").read_text()).keys() \
        == json.loads((tmp_path / "j.json").read_text()).keys()
    fs = [tM.fscore_from_dists(np.array([0.01, 0.2]), np.array([0.06, 0.0])),
          jM.fscore_from_dists(np.array([0.01, 0.2]), np.array([0.06, 0.0]))]
    assert fs[0] == fs[1]
    np.testing.assert_array_equal(
        tM.depth_error_ratio(np.array([0.0, 5, 90]), np.array([1, 4, 3.0])),
        jM.depth_error_ratio(np.array([0.0, 5, 90]), np.array([1, 4, 3.0])))


def test_meters_refuse_what_is_not_ported(monkeypatch):
    """LPIPS without a weights file reports NaN, as in the JAX package:
    no weights ship with the repository and none are downloaded."""
    monkeypatch.delenv("NVSF_TPU_LPIPS_WEIGHTS", raising=False)
    for path in (None, "missing_lpips.npz"):
        t, j = tM.LPIPSMeter(weights_path=path), \
            jM.LPIPSMeter(weights_path=path)
        assert t.available is j.available is False
        t.update(np.zeros((8, 8, 3)), np.ones((8, 8, 3)))
        assert np.isnan(t.measure())


def test_lpips_matches_jax(tmp_path):
    """LPIPS from synthetic AlexNet weights (the schema of
    tools/export_lpips_weights.py, narrow channels), to rtol 1e-5 (f32
    convolutions summed in another order); zero on identical images; the
    meter with a weights path averages it."""
    from nvsf_tpu.lib.lpips_jax import lpips_from_file as jax_lpips
    from nvsf_torch.lib.lpips import lpips_from_file
    from test_evaluate import _synthetic_lpips_npz
    path = _synthetic_lpips_npz(tmp_path / "w.npz")
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (40, 56, 3))
    b = np.clip(a + rng.normal(0, 0.2, a.shape), 0, 1)
    for x, y in ((a, b), (a[..., 0], b[..., 0])):
        ref = jax_lpips(path, x, y)
        assert ref > 0
        np.testing.assert_allclose(lpips_from_file(path, x, y), ref,
                                   rtol=1e-5)
    assert lpips_from_file(path, a, a) == pytest.approx(0.0, abs=1e-6)
    t, j = tM.LPIPSMeter(weights_path=path), jM.LPIPSMeter(weights_path=path)
    for m in (t, j):
        m.update(a, b)
        m.update(b, a)
    np.testing.assert_allclose(t.measure(), j.measure(), rtol=1e-5)


# ----------------------------------------------------------------------
# (d) the streaming occupancy marcher on bridged params and grid
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_stream_render_matches_jax(fields, lidar, monkeypatch):  # noqa: F811
    """``run_occupancy_stream`` and the sorted-chunk ``_render_staged_occ``
    on a grid with empty regions (so m varies and sky rays exit at once),
    K = 40 on slabs of 16 (the pad path), a ray batch of 48 (several
    chunks) and a dense field (density_scale 300) so that rays also die by
    transmittance."""
    jspec, params, field = fields
    N, T, K, G = 200, 64, 40, 16
    s = 1 / 81
    kw = dict(bound=1.0, min_near=1.0 * s, min_near_lidar=1.0 * s,
              lidar_max_depth=80.0 * s, active_sensor=True, num_steps=T,
              density_scale=300.0, max_ray_batch=48, stream_slab=16)
    jrend = RendererSpec(field=jspec, **kw)
    trend = Renderer(field=field, **kw)
    rng = np.random.default_rng(16)
    ro = rng.uniform(-0.05, 0.05, (N, 3)).astype(np.float32)
    rd = rng.standard_normal((N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    grid = np.zeros((G, G, G), np.float32)
    grid[:, :, :G // 2] = 32.0                 # the lower half is occupied
    grid[G // 2:, G // 2:] = 0.0               # but for one quadrant
    t = np.float32(1 / 3)
    jgrid, tgrid = jnp.asarray(grid), torch.from_numpy(grid)
    jocc, tocc = OccupancyGridSpec(grid_size=G), OccupancyGrid(grid_size=G)
    jro, jrd, tro, trd = (jnp.asarray(ro), jnp.asarray(rd),
                          torch.from_numpy(ro), torch.from_numpy(rd))
    dk, ik = ("depth_lidar", "image_lidar") if lidar else ("depth", "image")

    jo = jrend.run_occupancy_stream(params, jro, jrd, t, jocc, jgrid,
                                    num_steps_occ=K, cal_lidar_color=lidar,
                                    occ_thresh=1.0, slab=16)
    to = trend.run_occupancy_stream(tro, trd, torch.tensor(t), tocc, tgrid,
                                    num_steps_occ=K, cal_lidar_color=lidar,
                                    occ_thresh=1.0, slab=16)
    assert set(to) == set(jo)
    for k in to:
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)

    jo = jrend._render_staged_occ(params, jro, jrd, t, jocc, jgrid, K, 1.0,
                                  lidar, None, compact_chunk=64)
    trend.slabs_run.zero_()
    trend.slab_checks = 0
    monkeypatch.setattr(renderer_mod, "COMPACT_CHUNK", 64)
    to = trend._render_staged_occ(tro, trd, torch.tensor(t), tocc, tgrid, K,
                                  1.0, lidar, None)
    assert set(to) == set(jo)
    for k in (dk, ik):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)
    # 6 chunks of 48 rays x 3 slabs: the slabs that JAX's while_loop runs
    # over the same sorted chunks, some chunks exited early (sky chunks at
    # once); the CPU reads the predicate before each of the 18 slabs
    from test_torch_frame_graph import jax_frame_slabs
    expect = jax_frame_slabs(jrend, params, ro, rd, t, grid, K, lidar, 16,
                             48, 64)
    assert int(trend.slabs_run) == expect, (int(trend.slabs_run), expect)
    assert 0 < expect < 6 * 3, expect
    assert trend.slab_checks == 6 * 3, trend.slab_checks
    # without a grid: the dense uniform chunks of ``run``
    to = trend.render(tro, trd, torch.tensor(t), cal_lidar_color=lidar)
    assert set(to) == {dk, ik}
    assert to[dk].shape == (N,) and to[ik].shape == (N, 2 if lidar else 3)


# ----------------------------------------------------------------------
# (e) evaluate on bridged trainer state; (f) the card by default
# ----------------------------------------------------------------------

def test_evaluate_matches_jax(tmp_path, monkeypatch):
    """The port's ``evaluate`` and the JAX package's on the same bridged
    trainer state (perturbed weights, an occupancy grid with an empty
    half-space): the same categories, keys and values, and the same JSON
    error matrices. Both take their rays from one numpy function (see
    test_torch_step.py)."""
    from nvsf_tpu.train.evaluate import evaluate as jax_evaluate
    from nvsf_tpu.train.trainer import Trainer as JaxTrainer
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.trainer import Trainer

    _shared_rays(monkeypatch)
    cfg = _config(num_steps_occ=24, max_ray_batch=256, occ_grid_size=16,
                  ema_decay=0.5)
    jtr = JaxTrainer(cfg, jax_scene(JaxSceneSpec(**SPEC), split="train"),
                     workspace=str(tmp_path / "ws"))
    rng = np.random.default_rng(2)
    state = jax.tree.map(np.asarray, dict(jtr.state))
    for k in ("params", "ema_params"):
        state[k] = jax.tree.map(
            lambda a: (a + rng.standard_normal(a.shape) * 0.1
                       * max(float(np.abs(a).max()), 1e-3))
            .astype(np.float32), state[k])
    G = cfg.occ_grid_size
    grid = np.full((G, G, G), 32.0, np.float32)
    grid[:, :, :G // 2 - 3] = 0.0
    state["occ_grid_lidar"] = state["occ_grid_rgb"] = grid
    jtr.state.update(jax.tree.map(jnp.asarray, state))
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"), device="cpu")
    bridge.load_trainer_state(tr, state)
    live = {k: p.detach().clone() for k, p in tr.field.named_parameters()}

    res = {}
    for pkg, fn, trainer in (("jax", jax_evaluate, jtr),
                             ("torch", evaluate, tr)):
        d = tmp_path / pkg
        res[pkg] = fn(trainer, jax_scene(JaxSceneSpec(**SPEC), split="val")
                      if pkg == "jax" else make_synthetic_scene(
                          SyntheticSceneSpec(**SPEC), split="val"),
                      save_dir=str(d), name="e", log_fn=None)
    assert set(res["torch"]) == set(res["jax"]) \
        == {"combined", "background", "foreground"}
    for cat, r in res["torch"].items():
        ref = res["jax"][cat]
        assert set(r) == set(ref), cat
        for k in r:
            np.testing.assert_allclose(np.asarray(r[k], np.float64),
                                       np.asarray(ref[k], np.float64),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"{cat}/{k}")
        a = json.loads((tmp_path / "torch" /
                        f"e_error_matrix_{cat}.json").read_text())
        b = json.loads((tmp_path / "jax" /
                        f"e_error_matrix_{cat}.json").read_text())
        assert a.keys() == b.keys() and a["category"] == cat
    assert np.isfinite(res["torch"]["combined"]["point"][0])
    # use_ema scored the EMA field and left the trained parameters alone
    for k, p in tr.field.named_parameters():
        assert torch.equal(p, live[k]), k

    # use_refine: the same U-Net (random BN affine terms and statistics)
    # refines the raydrop before it masks the frame; the JAX reference runs
    # its U-Net jitted (the eager forward compiles op by op)
    from test_torch_refine import _trees
    uspec = jtr.unet_spec
    up, us = _trees(5, uspec)
    japply = jax.jit(lambda x: uspec.apply(up, us, x, train=False)[0])
    monkeypatch.setattr(jtr, "refine_raydrop_pano", lambda r, i, d: (
        np.asarray(japply(jnp.stack([r, i, d])[None]))[0, 0]))
    jtr.unet_trained = tr.unet_trained = True
    bridge.load_unet(tr.unet, up, us)
    refined = {}
    for pkg, fn, trainer in (("jax", jax_evaluate, jtr),
                             ("torch", evaluate, tr)):
        refined[pkg] = fn(trainer, jax_scene(JaxSceneSpec(**SPEC),
                                             split="val")
                          if pkg == "jax" else make_synthetic_scene(
                              SyntheticSceneSpec(**SPEC), split="val"),
                          use_refine=True, log_fn=None)
    for cat, r in refined["torch"].items():
        for k in r:
            np.testing.assert_allclose(
                np.asarray(r[k], np.float64),
                np.asarray(refined["jax"][cat][k], np.float64), rtol=1e-4,
                atol=1e-5, err_msg=f"refined {cat}/{k}")
    assert refined["torch"]["combined"]["raydrop"] \
        != res["torch"]["combined"]["raydrop"]


def test_entry_points_run_on_the_card_by_default():
    """Without ``device`` the trainer and the PointsMeter take the card;
    with no card they raise instead of running on the CPU."""
    from nvsf_torch.train.trainer import Trainer
    scene = make_synthetic_scene(SyntheticSceneSpec(**SPEC))
    if torch.cuda.is_available():
        assert Trainer(_config(), scene).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_config(), scene)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tM.PointsMeter(1.0, (10.0, 40.0))
    assert Trainer(_config(), scene, device="cpu").device.type == "cpu"
