"""The port's CLI and the modules around it against the JAX package on the
CPU: scene loading with and without novel-sensor overrides (on the
mini KITTI-360 fixture of test_preprocess.py), the density grid, marching
tetrahedra and the PLY, then the CLI itself: train, evaluate, refine,
``--test --test_eval --use_refine`` on the synthetic scene, and a
novel-sensor ``--test`` on the mini KITTI-360 scene; and the logging,
profiling, recovery, PNG and checkpoint-loading helpers.

Tolerances: scene loading, marching tetrahedra and the PLY are the same
numpy code on the same inputs and must agree exactly; the density grid
runs the field in f32 in both frameworks (rtol 1e-4, atol 1e-5, as the
renderer parity tests).
"""

import collections
import os
import pickle
import types

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

from nvsf_tpu import config as jconfig
from nvsf_tpu.data.kitti360 import load_kitti360_scene as jax_kitti
from nvsf_tpu.render import export as jexport
from nvsf_torch import config as tconfig
from nvsf_torch.data.kitti360 import load_kitti360_scene as port_kitti
from nvsf_torch.render import export as texport
from nvsf_torch.scripts.main_nvsf import main as cli_main
from nvsf_torch.train import checkpoint as tckpt

from test_preprocess import mini_kitti  # noqa: F401  (a fixture)
from test_torch_models import fields, one_torch_thread  # noqa: F401

# the toy sizes of tests/test_cli.py, in occupancy render mode with a
# 16-sample budget (tests/test_torch_uniform.py runs the uniform default)
TOY = ["--render_mode", "occupancy", "--num_steps_occ", "16",
       "--num_rays_lidar", "128", "--num_steps", "32",
       "--max_ray_batch", "256", "--min_resolution", "8",
       "--n_levels_plane", "2", "--base_resolution", "16",
       "--max_resolution", "64", "--n_levels_hash", "2",
       "--flow_n_levels", "2", "--flow_log2_hashmap_size", "6"]


# ----------------------------------------------------------------------
# scene loading on the mini KITTI-360 tree
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def kitti_config(mini_kitti, tmp_path_factory):  # noqa: F811
    base, src, _ = mini_kitti
    ws = tmp_path_factory.mktemp("kitti_cli")
    from nvsf_torch.preprocess import kitti360 as K
    path = K.preprocess_kitti360(
        src, base, "1908", recording="2013_05_28_drive_0000",
        config_dir=str(ws / "configs"), workspace=str(ws / "run"),
        log_fn=lambda *a: None, H=16, W=64)
    return str(path), ws


NOVEL = ["--delta_position", "0", "0", "1.0",
         "--delta_orientation", "0", "0", "5.0",
         "--V_lidar_ch", "8", "--H_lidar_ch", "32",
         "--intrinsics_lidar_new", "10.0", "40.0",
         "--delta_pos_camera", "0.5", "0", "0", "--H_new", "12",
         "--W_new", "16"]


@pytest.mark.parametrize("split,novel", [("train", False), ("test", False),
                                         ("test", True)],
                         ids=["train", "test", "test-novel-sensor"])
def test_load_scene_matches_jax(kitti_config, split, novel):
    from nvsf_tpu.scripts.main_nvsf import _novel_sensor_dict as jax_ns
    from nvsf_torch.scripts.main_nvsf import _novel_sensor_dict as port_ns
    argv = ["--config", kitti_config[0]] + (NOVEL if novel else [])
    jcfg, tcfg = jconfig.load_config(argv), tconfig.load_config(argv)
    assert (port_ns(tcfg) is None) == (not novel)
    assert port_ns(tcfg) == jax_ns(jcfg)
    ref = jax_kitti(jcfg, split, novel_sensor=jax_ns(jcfg))
    got = port_kitti(tcfg, split, novel_sensor=port_ns(tcfg))
    assert len(got) == len(ref) and len(got) == (60 if split == "train"
                                                 else 4)
    for k, v in vars(ref).items():
        g = getattr(got, k)
        if k == "annotations":
            assert len(g) == len(v) and any(v)
            for fg, fr in zip(g, v):
                assert [(a["label"], a["dynamic"]) for a in fg] \
                    == [(a["label"], a["dynamic"]) for a in fr]
                for a, b in zip(fg, fr):
                    np.testing.assert_array_equal(a["vertices"],
                                                  b["vertices"])
        elif v is None or isinstance(v, (int, str, tuple)):
            assert g == v, k
        else:
            np.testing.assert_array_equal(g, v, err_msg=k)
    if novel:
        assert got.images_lidar is None and got.images is None
        assert (got.H_lidar, got.W_lidar, got.H, got.W) == (10, 32, 12, 16)


# ----------------------------------------------------------------------
# mesh export
# ----------------------------------------------------------------------

def test_mesh_export_matches_jax(fields, tmp_path):  # noqa: F811
    """The EMA field's density on a grid (the trainer's device, chunks),
    then marching tetrahedra and the PLY on a sphere's signed distance."""
    jspec, params, field = fields
    kw = dict(bound_min=(-0.6, -0.5, -0.4), bound_max=(0.5, 0.6, 0.3),
              xyz_res=(9, 7, 5), t=0.4)
    ref = jexport.extract_density_grid(types.SimpleNamespace(
        state={"ema_params": params}, field=jspec), **kw)
    got = texport.extract_density_grid(types.SimpleNamespace(
        device=torch.device("cpu"), ema_field=field), chunk=100, **kw)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)

    xs = np.linspace(-1, 1, 21)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    grid = 0.6 - np.sqrt(X ** 2 + Y ** 2 + Z ** 2)
    box = ((-1, -1, -1), (1, 1, 1))
    verts, faces = texport.marching_tetrahedra(grid, 0.0, *box)
    jverts, jfaces = jexport.marching_tetrahedra(grid, 0.0, *box)
    assert len(faces) > 100
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    texport.write_ply(str(tmp_path / "t.ply"), verts, faces)
    jexport.write_ply(str(tmp_path / "j.ply"), jverts, jfaces)
    assert (tmp_path / "t.ply").read_bytes() \
        == (tmp_path / "j.ply").read_bytes()


# ----------------------------------------------------------------------
# the CLI
# ----------------------------------------------------------------------

def _toy_train_argv(ws):
    return ["--dataloader", "synthetic", "--path", "unused",
            "--sequence_id", "syn", "--num_frames", "4", "--scale", "0.04",
            "--lidar_max_depth", "20", "--min_near_lidar", "0.5",
            "--intrinsics_lidar", "10.0", "40.0",
            "--intrinsics_hoz_lidar", "180.0", "360.0", "--enable_lidar",
            "--grad_loss", "--epochs", "2", "--eval_interval", "2",
            "--log2_hashmap_size", "10", "--flow_base_resolution", "8",
            "--flow_max_resolution", "16", "--time_resolution", "4",
            "--workspace", str(ws), "--ckpt", "scratch", "--name", "smoke",
            "--refine_steps", "5"] + TOY


def test_cli_train_then_test(tmp_path):
    """Training (evals, checkpoints, a device trace of the first warm
    epoch, the refine stage and the refined eval), then
    ``--test --test_eval --use_refine`` from the refine checkpoint, on the
    synthetic scene at toy sizes with the shipped config's grad_loss; the
    artifacts of tests/test_cli.py and more."""
    ws = tmp_path / "ws"
    argv = _toy_train_argv(ws)
    tr = cli_main(argv + ["--profile_dir", str(tmp_path / "trace")],
                  device="cpu")
    assert [p for p in (tmp_path / "trace").rglob("*.json") if p.is_file()]
    assert tr.has_unet and tr.epoch == 2
    for stage in ("train epoch", "eval ep0002", "refine render",
                  "refine unet", "refined eval"):
        assert tr.timers.counts[stage] >= 1, stage
    ckpts = os.listdir(ws / "checkpoints")
    assert {"smoke_ep0002.pkl", "smoke_refine.pkl"} <= set(ckpts)
    log = (ws / "log_smoke.txt").read_text()
    assert "[refine] iter 0 loss" in log and "loss_sr=" in log
    val = os.listdir(ws / "validation")
    assert "smoke_ep0002_error_matrix_combined.json" in val
    assert "smoke_ep0002_refined_error_matrix_combined.json" in val

    argv[argv.index("scratch")] = "latest"
    tr = cli_main(argv + ["--test", "--test_eval", "--use_refine",
                          "--mesh_xyz_res", "24", "24", "12"], device="cpu")
    assert tr.has_unet
    files = os.listdir(ws / "results")
    for suffix in ("_depth.png", "_intensity.png", "_pcd_lidar.txt",
                   "_pcd_world.txt", "_lidar.pcd", "_error_matrix_combined"
                   ".json"):
        assert any(f.endswith(suffix) for f in files), suffix
    assert "smoke_mesh.ply" in files
    depth = imageio.imread(ws / "results" / "smoke_0000_depth.png")
    assert depth.shape == (32, 96) and depth.dtype == np.uint8


def test_cli_novel_sensor_test_on_mini_kitti(kitti_config):
    """``--test`` with a pose delta, 8 beams (+2 extreme rows), 32 columns
    and a new vertical FoV renders a GT-less scene from a checkpoint: the
    novel geometry reaches the PNGs and the point clouds."""
    cfg_path, ws = kitti_config
    common = ["--config", cfg_path, "--workspace", str(ws / "run"),
              "--flow_loss", "--use_error_map", "--num_rays", "128",
              "--log2_hashmap_size", "8", "--flow_base_resolution", "8",
              "--flow_max_resolution", "16"] + TOY
    from nvsf_torch.train.trainer import Trainer
    cfg = tconfig.load_config(common).finalize(steps_per_epoch=1)
    Trainer(cfg, port_kitti(cfg, "test"), device="cpu").save_checkpoint()
    cli_main(common + ["--test", "--ckpt", "latest",
                       "--delta_position", "0", "0", "1.0",
                       "--V_lidar_ch", "8", "--H_lidar_ch", "32",
                       "--intrinsics_lidar_new", "10.0", "40.0",
                       "--mesh_xyz_res", "16", "16", "8"], device="cpu")
    res = ws / "run" / "results"
    files = sorted(os.listdir(res))
    for suffix in ("_depth.png", "_pcd_lidar.txt", "_pcd_world.txt",
                   "_rgb.png", "_mesh.ply"):
        assert any(f.endswith(suffix) for f in files), suffix
    depth_png = [f for f in files if f.endswith("_depth.png")][0]
    assert imageio.imread(res / depth_png).shape[:2] == (10, 32)


def test_cli_mesh_shape_trains_on_two_ranks(tmp_path):
    """``--mesh_shape 2`` on the CPU: two ranks over gloo train two epochs,
    evaluate, refine and evaluate again; rank 0 alone writes each
    checkpoint (once) and the log. The eval matrices match a single
    process's run of the same argv to rtol 1e-4 (atol 1e-6): the ranks
    draw the same batches and average gradients that differ from one
    process's by f32 summation order (~3e-6 of their largest magnitude),
    and each rank's marcher chunks its own rays; on this run the meters
    differed by up to 1e-7 before the refine and 3e-5 (the refined
    raydrop meter) after it."""
    import json
    runs = {}
    for mode, extra in (("mesh", ["--mesh_shape", "2"]), ("single", [])):
        ws = tmp_path / mode
        runs[mode] = cli_main(_toy_train_argv(ws) + extra, device="cpu")
    ranks, single = runs["mesh"], runs["single"]
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["epoch"] == 2 and r["has_unet"]
               and r["global_step"] == single.global_step for r in ranks)
    written = [os.path.basename(p) for p in ranks[0]["checkpoints"]]
    assert sorted(written) == ["smoke_best.pkl", "smoke_ep0002.pkl",
                               "smoke_refine.pkl"]
    assert ranks[1]["checkpoints"] == []
    assert sorted(os.listdir(tmp_path / "mesh" / "checkpoints")) \
        == sorted(written)
    assert ranks[0]["collectives"]["all_reduce grads"]["calls"] \
        >= single.global_step
    log = (tmp_path / "mesh" / "log_smoke.txt").read_text()
    assert log.count("[epoch 2] loss=") == 1
    for stem in ("smoke_ep0002", "smoke_ep0002_refined"):
        got, ref = (json.loads((tmp_path / m / "validation" / f"{stem}"
                                "_error_matrix_combined.json").read_text())
                    for m in ("mesh", "single"))
        assert set(got) == set(ref)
        for k, v in ref.items():
            if isinstance(v, (int, float, list)):
                np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                           np.asarray(v, np.float64),
                                           rtol=1e-4, atol=1e-6,
                                           err_msg=f"{stem} {k}")


def test_cli_refuses_more_ranks_than_cards_and_missing_checkpoints(
        tmp_path, monkeypatch):
    """A ``mesh_shape`` asking for more ranks than there are cards raises
    before anything starts (the JAX package would take the first
    devices); so does a test run without a checkpoint."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for spec in ("2", "2x2"):
        with pytest.raises(ValueError, match="ranks, one to a card, and 1"):
            cli_main(["--mesh_shape", spec, "--workspace", str(tmp_path)])
    assert not os.listdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        cli_main(["--dataloader", "synthetic", "--enable_lidar", "--test",
                  "--workspace", str(tmp_path), "--ckpt", "latest"] + TOY,
                 device="cpu")


# ----------------------------------------------------------------------
# logging, profiling, recovery, PNGs, checkpoint loading
# ----------------------------------------------------------------------

def test_logging_and_profiling(tmp_path):
    from nvsf_torch.train.logging import (Logger, count_parameters,
                                          model_summary,
                                          save_sampling_heatmap)
    from nvsf_torch.train.profiler import PhaseTimers, device_trace
    log = Logger(str(tmp_path), "t", quiet=True)
    log("hello", 123)
    log.close()
    assert "hello 123" in (tmp_path / "log_t.txt").read_text()
    params = {"a.0": torch.zeros(3, 4), "a.1": torch.zeros(2),
              "b": torch.zeros(7)}
    assert count_parameters(params) == 21
    s = model_summary(params)
    assert "TOTAL" in s and "21" in s and "14" in s
    save_sampling_heatmap(np.random.default_rng(0).uniform(1, 9, (5, 7)),
                          str(tmp_path / "hm" / "h.png"))
    assert imageio.imread(tmp_path / "hm" / "h.png").shape == (5, 7)

    synced = []
    tm = PhaseTimers(sync=lambda: synced.append(1))
    for _ in range(2):
        with tm.phase("a"):
            pass
    assert tm.counts["a"] == 2 and len(synced) == 2 and "a" in tm.report()
    with device_trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert list((tmp_path / "trace").glob("trace_*.json"))


def test_recovery_resumes_from_the_latest_checkpoint():
    from nvsf_torch.train.resilience import (is_recoverable,
                                             run_epochs_with_recovery)
    assert is_recoverable(
        torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to ..."))
    # a bug or a broken CUDA context is not retried, whatever its text
    for err in (ValueError("shape mismatch"),
                RuntimeError("INTERNAL ASSERT FAILED at ..."),
                RuntimeError("CUDA error: out of memory"),
                RuntimeError("UNAVAILABLE: device lost")):
        assert not is_recoverable(err), err

    class Stub:
        epoch, failed, loads, drops = 0, False, 0, 0

        def drop_step_graphs(self):
            self.drops += 1

        def train_one_epoch(self):
            if self.epoch == 3 and not self.failed:
                self.failed = True
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")
            return self.epoch

        def load_checkpoint(self, which):
            self.loads += 1
            self.epoch = 2
            return True
    seen = []
    tr = Stub()
    run_epochs_with_recovery(tr, 1, 4, lambda ep, st: seen.append(ep),
                             backoff_s=0.0, log_fn=None)
    assert seen == [1, 2, 3, 4] and tr.loads == 1 and tr.drops == 1
    tr.train_one_epoch = lambda: (_ for _ in ()).throw(ValueError("bug"))
    with pytest.raises(ValueError):
        run_epochs_with_recovery(tr, 1, 2, lambda e, s: None, backoff_s=0.0,
                                 log_fn=None)


def test_png_writer_round_trips(tmp_path):
    from nvsf_torch.lib.tools import write_png
    rng = np.random.default_rng(0)
    for shape in ((7, 11), (5, 9, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        write_png(str(tmp_path / "x.png"), img)
        np.testing.assert_array_equal(imageio.imread(tmp_path / "x.png"),
                                      img)
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "y.png"), np.zeros((2, 2, 4), np.uint8))


class _Foreign:
    pass


def test_checkpoint_loader_reads_optax_state_and_refuses_other_objects(
        tmp_path):
    """A JAX checkpoint's optax state classes load as tuples of their
    class name (no optax needed); any other class is refused."""
    import optax
    state = optax.scale_by_adam().init({"w": np.zeros(3, np.float32)})
    path = tmp_path / "a.pkl"
    path.write_bytes(pickle.dumps(
        {"opt_state": jax.tree.map(np.asarray, state), "step": 3}))
    got = tckpt.load_checkpoint(str(path))["opt_state"]
    assert type(got).__name__ == "ScaleByAdamState"
    count, mu, nu = got
    assert int(count) == 0 and mu["w"].shape == (3,)
    path.write_bytes(pickle.dumps({"x": _Foreign()}))
    with pytest.raises(pickle.UnpicklingError, match="_Foreign"):
        tckpt.load_checkpoint(str(path))
    # numpy holds functions that run code: only its array names pass
    # (run, this one would raise ZeroDivisionError)
    path.write_bytes(pickle.dumps({"x": _RunsCode()}))
    with pytest.raises(pickle.UnpicklingError, match="runstring"):
        tckpt.load_checkpoint(str(path))


class _RunsCode:
    def __reduce__(self):
        from numpy.testing._private.utils import runstring
        return runstring, ("1 / 0", {})


@pytest.mark.parametrize("protocol", [2, 4, 5])
def test_checkpoint_loader_reads_numpy_pickles(tmp_path, protocol):
    """Arrays (contiguous and strided), scalars and dtypes round-trip
    through the restricted unpickler under each pickle protocol."""
    rng = np.random.default_rng(protocol)
    payload = collections.OrderedDict(
        a=rng.normal(size=(3, 4)).astype(np.float32),
        b=rng.integers(0, 9, (4, 6)).astype(np.uint32)[:, ::2],
        s=np.float32(1.5), i=np.int64(7), d=np.dtype("f2"),
        nested=[{"t": (np.zeros(2, np.int8), 3, "x", None)}])
    path = tmp_path / "n.pkl"
    path.write_bytes(pickle.dumps(payload, protocol=protocol))
    got = tckpt.load_checkpoint(str(path))
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k], payload[k])
        assert got[k].dtype == payload[k].dtype
    assert got["s"] == payload["s"] and got["s"].dtype == np.float32
    assert got["i"] == 7 and got["d"] == np.dtype("f2")
    assert got["nested"][0]["t"][1:] == (3, "x", None)


def test_novel_sensor_on_a_scaled_scene():
    """The synthetic scene takes the overrides on poses that are already
    scaled (positions times ``scale``), as the loader applies them to
    metric poses before scaling."""
    from nvsf_torch.data.dataset import apply_novel_sensor
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    ns = {"delta_position": [0.5, -1.0, 1.0], "delta_orientation": [0, 3, 5],
          "H_lidar_new": 8, "W_lidar_new": 32, "delta_pos_camera": [1, 0, 0],
          "delta_orient_camera": [0, 0, 2], "H_new": 20, "W_new": 28}
    s = 0.04
    scaled = make_synthetic_scene(SyntheticSceneSpec(num_frames=3, scale=s))
    metric = make_synthetic_scene(SyntheticSceneSpec(num_frames=3,
                                                     scale=1.0))
    got = apply_novel_sensor(scaled, ns, scale=s)
    ref = apply_novel_sensor(metric, ns)
    for k in ("poses_lidar", "poses"):
        r = getattr(ref, k).copy()
        r[:, :3, 3] *= s
        np.testing.assert_allclose(getattr(got, k), r, rtol=1e-5,
                                   atol=1e-7)
    assert (got.H_lidar, got.W_lidar, got.H, got.W) == (10, 32, 20, 28)
    assert got.images_lidar is None and scaled.images_lidar is not None
