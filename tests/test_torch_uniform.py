"""The dense uniform render mode (the JAX package's default) of the port
against the JAX package on the CPU: ``Renderer.run`` with and without its
jitter and with a background, the staged dense ``render``, the chunked
recomputed density query (``remat_chunks``), ``sample_pdf`` and importance
resampling, one uniform-mode training step (random and patch) on the JAX
step's draws, uniform checkpoints both ways, ``Trainer.train``, the CLI on
the JAX CLI test's argv, and the quality-protocol script at a tiny size.

Tolerances: renders rtol 1e-4 / atol 1e-5 and gradients 1e-4 of each
parameter's largest JAX gradient, as the occupancy renderer's parity tests
(f32 transcendentals and sums differ at the ulp level between XLA and
PyTorch); the remat chunks against one query: outputs to 1e-6 and
gradients within 1e-5 of each gradient's largest magnitude (the same
per-point functions, gradients summed over chunks in another order); the
step with ``test_step_matches_jax``'s tolerances.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nvsf_tpu.render.renderer import RendererSpec
from nvsf_tpu.render.renderer import sample_pdf as jax_sample_pdf
from nvsf_tpu.train.trainer import Trainer as JaxTrainer
from nvsf_torch import bridge
from nvsf_torch.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.render.renderer import Renderer, sample_pdf
from nvsf_torch.train.trainer import Trainer

from test_torch_models import _compare_grads, fields  # noqa: F401
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_step import (SPEC, _check_error_map, _config, _jax_draws,
                             _jax_step, _shared_rays, _tree_equal)

FWD = dict(rtol=1e-4, atol=1e-5)
# rays x samples of the field's queries in the parity tests (the upsampled
# run's 32 + 16 samples included): one shape, whose operations the JAX
# side then compiles once
N_RAYS, N_SAMPLES = 64, 48
# two levels per encoder, for the trainer tests: the JAX step traces and
# compiles in about half the time of the four-level field's
SMALL = dict(n_levels_plane=2, n_levels_hash=2, flow_n_levels=2)
S = 1 / 81
RENDER = dict(bound=1.0, min_near=1.0 * S, min_near_lidar=1.0 * S,
              lidar_max_depth=80.0 * S, active_sensor=True)


def _rays(seed, N):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.05, 0.05, (N, 3)).astype(np.float32)
    rd = rng.standard_normal((N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    return ro, rd


def _keys(lidar):
    return ("depth_lidar", "image_lidar") if lidar else ("depth", "image")


# ----------------------------------------------------------------------
# Renderer.run, render, remat chunks, sample_pdf
# ----------------------------------------------------------------------

@pytest.mark.parametrize("lidar,perturb,bg", [
    (True, False, False), (True, True, False), (False, False, False),
    (False, True, True)],
    ids=["lidar", "lidar-perturb", "camera", "camera-perturb-bg"])
def test_run_matches_jax(fields, lidar, perturb, bg):  # noqa: F811
    """``run`` against ``RendererSpec.run`` on bridged weights, the JAX
    jitter's draws injected: every output, and every parameter gradient of
    a random projection of depth and image."""
    jspec, params, field = fields
    N, T = N_RAYS, N_SAMPLES
    jrend = RendererSpec(field=jspec, num_steps=T, **RENDER)
    trend = Renderer(field=field, num_steps=T, **RENDER)
    ro, rd = _rays(20, N)
    rng = np.random.default_rng(21)
    bg_c = rng.uniform(size=(N, 3)).astype(np.float32) if bg else None
    key = jax.random.PRNGKey(22) if perturb else None
    draws = {}
    if perturb:
        _, kz = jax.random.split(key)
        draws["z_noise"] = torch.from_numpy(np.asarray(
            jax.random.uniform(kz, (N, T))))
    t = np.float32(1 / 3)
    dk, ik = _keys(lidar)
    cd = rng.standard_normal(N).astype(np.float32)
    ci = rng.standard_normal((N, 2 if lidar else 3)).astype(np.float32)

    def jf(p):
        o = jrend.run(p, jnp.asarray(ro), jnp.asarray(rd), t,
                      cal_lidar_color=lidar, perturb=perturb, key=key,
                      bg_color=None if bg_c is None else jnp.asarray(bg_c))
        return jnp.sum(o[dk] * cd) + jnp.sum(o[ik] * ci), o

    (_, jo), jg = jax.value_and_grad(jf, has_aux=True)(params)
    field.zero_grad(set_to_none=True)
    o = trend.run(torch.from_numpy(ro), torch.from_numpy(rd), torch.tensor(t),
                  cal_lidar_color=lidar, perturb=perturb,
                  bg_color=None if bg_c is None else torch.from_numpy(bg_c),
                  **draws)
    assert set(o) == set(jo)
    for k in o:
        np.testing.assert_allclose(o[k].detach().numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)
    ((o[dk] * torch.from_numpy(cd)).sum()
     + (o[ik] * torch.from_numpy(ci)).sum()).backward()
    _compare_grads(jg, field)


@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_render_without_grid_matches_jax(fields, lidar):  # noqa: F811
    """``render`` without an occupancy grid: staged chunks of the dense
    ``run``, 100 rays in chunks of 64 (the last one short), against
    ``render(staged=True)``."""
    jspec, params, field = fields
    N, T = 100, N_SAMPLES
    kw = dict(num_steps=T, max_ray_batch=N_RAYS, **RENDER)
    jrend = RendererSpec(field=jspec, **kw)
    trend = Renderer(field=field, **kw)
    ro, rd = _rays(23, N)
    t = np.float32(0.6)
    jo = jrend.render(params, jnp.asarray(ro), jnp.asarray(rd), t,
                      cal_lidar_color=lidar, staged=True)
    to = trend.render(torch.from_numpy(ro), torch.from_numpy(rd),
                      torch.tensor(t), cal_lidar_color=lidar)
    assert set(to) == set(jo) == set(_keys(lidar))
    for k in to:
        assert to[k].shape[0] == N and not to[k].requires_grad
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)


@pytest.mark.parametrize("path", ["run", "run_occupancy"])
def test_remat_chunks_match_one_query(fields, path):  # noqa: F811
    """``remat_chunks=3`` over N x T = 1,600 points (not a multiple of 3)
    gives the outputs and gradients of one query; the recomputed chunks
    run the field's forward again in the backward."""
    _, _, field = fields
    N, T, K, G = 50, 32, 16, 16
    ro, rd = _rays(24, N)
    rng = np.random.default_rng(25)
    z_noise = torch.from_numpy(rng.uniform(size=(N, T)).astype(np.float32))
    jitter_u = torch.from_numpy(rng.uniform(size=(N, K)).astype(np.float32))
    cd = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    ci = torch.from_numpy(rng.standard_normal((N, 2)).astype(np.float32))
    grid = torch.full((G, G, G), 32.0)
    grid[:, :, :G // 2 - 2] = 0.0
    results = []
    for chunks in (1, 3):
        rend = Renderer(field=field, num_steps=T, remat_chunks=chunks,
                        **RENDER)
        calls = []
        orig = field.density
        field.density = lambda *a, **k: calls.append(1) or orig(*a, **k)
        try:
            field.zero_grad(set_to_none=True)
            args = (torch.from_numpy(ro), torch.from_numpy(rd),
                    torch.tensor(0.4))
            if path == "run":
                o = rend.run(*args, cal_lidar_color=True, perturb=True,
                             z_noise=z_noise)
            else:
                o = rend.run_occupancy(
                    *args, OccupancyGrid(grid_size=G), grid,
                    num_steps_occ=K, cal_lidar_color=True, perturb=True,
                    z_noise=z_noise, jitter_u=jitter_u, occ_thresh=1.0)
            ((o["depth_lidar"] * cd).sum()
             + (o["image_lidar"] * ci).sum()).backward()
        finally:
            del field.density
        # each chunk's forward runs once more in the backward
        assert len(calls) == (1 if chunks == 1 else 2 * chunks), calls
        results.append(({k: v.detach() for k, v in o.items()},
                        {k: p.grad.clone() for k, p in
                         field.named_parameters() if p.grad is not None}))
    (o1, g1), (o3, g3) = results
    for k in o1:
        np.testing.assert_allclose(o3[k].numpy(), o1[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    assert set(g3) == set(g1)
    for k in g1:
        np.testing.assert_allclose(
            g3[k].numpy(), g1[k].numpy(), rtol=0, err_msg=k,
            atol=1e-5 * max(float(g1[k].abs().max()), 1e-12))


def test_sample_pdf_matches_jax():
    """Deterministic and injected draws, on weights with empty bins."""
    rng = np.random.default_rng(26)
    B, T, n = 64, 24, 16
    bins = np.sort(rng.uniform(0.1, 1.0, (B, T)), -1).astype(np.float32)
    w = rng.uniform(size=(B, T - 1)).astype(np.float32)
    w[w < 0.3] = 0.0
    for det in (True, False):
        u = None if det else rng.uniform(size=(B, n)).astype(np.float32)
        ref = jax_sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), n,
                             det=True) if det else None
        if not det:
            # the JAX function draws its own u: rebuild it from a key
            key = jax.random.PRNGKey(27)
            u = np.asarray(jax.random.uniform(key, (B, n)))
            ref = jax_sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), n)
        got = sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), n,
                         det=det,
                         u=None if det else torch.from_numpy(u))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6, err_msg=f"det={det}")


@pytest.mark.parametrize("perturb", [False, True], ids=["det", "perturb"])
def test_run_with_upsample_matches_jax(fields, perturb):  # noqa: F811
    """``upsample_steps`` 16 of 32 coarse samples: the coarse pass, the CDF
    draws (evenly spaced without jitter, the JAX key's with it) and the
    render over the 48 merged samples, outputs and the gradients of every
    parameter but the flow field's.

    The resampled depths come from a cumulative sum that each framework
    rounds its own way, so a sample can lie an ulp to either side of a
    K-plane cell edge, where the slope of the warped lookup jumps; that
    slope is what the flow field's gradient carries. test_run_matches_jax
    holds the flow field's gradient through ``run``, where the depths are
    the same bits in both frameworks."""
    jspec, params, field = fields
    N, U = N_RAYS, 16
    T = N_SAMPLES - U
    kw = dict(num_steps=T, upsample_steps=U, **RENDER)
    jrend = RendererSpec(field=jspec, **kw)
    trend = Renderer(field=field, **kw)
    ro, rd = _rays(28, N)
    key = jax.random.PRNGKey(29) if perturb else None
    draws = {}
    if perturb:
        k, kz = jax.random.split(key)
        draws = dict(
            z_noise=torch.from_numpy(np.asarray(
                jax.random.uniform(kz, (N, T)))),
            resample_u=torch.from_numpy(np.asarray(
                jax.random.uniform(k, (N, U)))))
    t = np.float32(0.5)
    rng = np.random.default_rng(30)
    cd = rng.standard_normal(N).astype(np.float32)

    def jf(p):
        o = jrend.run(p, jnp.asarray(ro), jnp.asarray(rd), t,
                      cal_lidar_color=True, perturb=perturb, key=key)
        return jnp.sum(o["depth_lidar"] * cd), o

    (_, jo), jg = jax.value_and_grad(jf, has_aux=True)(params)
    field.zero_grad(set_to_none=True)
    o = trend.run(torch.from_numpy(ro), torch.from_numpy(rd), torch.tensor(t),
                  cal_lidar_color=True, perturb=perturb, **draws)
    assert o["z_vals"].shape == (N, T + U)
    for k in o:
        np.testing.assert_allclose(o[k].detach().numpy(), np.asarray(jo[k]),
                                   err_msg=k, **FWD)
    (o["depth_lidar"] * torch.from_numpy(cd)).sum().backward()
    _compare_grads(jg, field, {n.split(".")[0] for n, _ in
                               field.named_parameters()} - {"flow"})


# ----------------------------------------------------------------------
# the trainer in uniform mode
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def upair(tmp_path_factory):
    """A JAX and a port trainer in uniform mode on one bridged state with
    non-trivial error maps."""
    cfg = _config(grad_loss=True, render_mode="uniform", num_steps=32,
                  **SMALL)
    jtr = JaxTrainer(cfg, jax_scene(JaxSceneSpec(**SPEC), split="train"),
                     workspace=str(tmp_path_factory.mktemp("jax_uniform")))
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"), device="cpu")
    assert "occ_grid_lidar" not in jtr.state and tr.occ is None
    assert tr.occ_grid_lidar is None and tr.occ_grid_rgb is None
    rng = np.random.default_rng(31)
    state = dict(jtr.state)
    for k in ("error_map", "error_map_rgb"):
        state[k] = jnp.asarray(
            rng.uniform(1, 100, state[k].shape).astype(np.float32))
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, state))
    return cfg, jtr, state, tr


@pytest.mark.parametrize("patch", [True, False], ids=["patch", "random"])
def test_uniform_step_matches_jax(upair, patch, monkeypatch):
    """One uniform-mode step (dense ``run`` for both branches, the z-jitter
    of the JAX step injected): loss, parts, gradients and error map."""
    cfg, jtr, state, tr = upair
    _shared_rays(monkeypatch)
    fi = 2
    draws = _jax_draws(jtr, state, fi, patch)
    new_state, metrics = _jax_step(jtr, state, fi, patch)
    jgrads = bridge.flatten_tree(jax.tree.map(np.asarray,
                                              new_state["opt_state"]))
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, state))
    tr.field.zero_grad(set_to_none=True)
    em0 = tr.error_map[fi].clone()
    loss, parts, em_in = tr.loss_and_grads(fi, patch, draws)

    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-4)
    assert set(parts) == {"loss_d", "loss_i", "loss_rd", "chamfer", "flow",
                          "urf", "rgb"} | ({"loss_sr"} if patch else set())
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    for name, p in tr.field.named_parameters():
        ref = jgrads[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    from nvsf_torch.data import sampler
    inds, err = em_in["lidar"]
    em1 = sampler.update_error_map(em0, inds, err, tr.scene.H_lidar,
                                   tr.scene.W_lidar)
    _check_error_map(em0.numpy(), np.asarray(new_state["error_map"][fi]),
                     em1.numpy(), inds.numpy(), err.numpy(),
                     tr.scene.H_lidar, tr.scene.W_lidar)


def test_uniform_checkpoints_both_ways(upair, tmp_path, monkeypatch):
    """A uniform checkpoint holds no occupancy grid. The port's full
    checkpoint, after a real step, loads into the JAX trainer, and the JAX
    trainer's into the port, every array bit for bit."""
    cfg, jtr, state, tr = upair
    _shared_rays(monkeypatch)
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, state))
    tr.train_step(1, False, _jax_draws(jtr, state, 1, False))
    tr.epoch = 2
    tr.workspace = str(tmp_path / "port")
    path = tr.save_checkpoint(full=True)
    with open(path, "rb") as f:
        raw = pickle.load(f)
    assert raw["occ_grid_lidar"] is None and raw["occ_grid_rgb"] is None
    payload = bridge.export_trainer_state(tr)
    saved = dict(jtr.state)
    try:
        assert jtr.load_checkpoint(path)
        _tree_equal(jtr.state["params"], payload["model"])
        _tree_equal(jtr.state["ema_params"], payload["ema"])
        for k in ("error_map", "error_map_rgb"):
            np.testing.assert_array_equal(np.asarray(jtr.state[k]),
                                          payload[k], err_msg=k)
        assert "occ_grid_lidar" not in jtr.state
        assert (jtr.epoch, jtr.global_step) == (2, tr.global_step)

        jtr.workspace = str(tmp_path / "jax")
        jtr.epoch, jtr.global_step = 5, 9
        jpath = jtr.save_checkpoint(full=True)
    finally:
        jtr.state = saved
    tr.workspace = str(tmp_path / "jax")
    assert tr.load_checkpoint("latest")
    assert jpath.endswith("ep0005.pkl")
    got = bridge.export_trainer_state(tr)
    _tree_equal(got["model"], payload["model"])
    _tree_equal(got["ema"], payload["ema"])
    assert (tr.epoch, tr.global_step) == (5, 9)
    assert tr.occ_grid_lidar is None and tr.occ_grid_rgb is None


def test_train_runs_epochs_and_checkpoints(tmp_path):
    """``Trainer.train``: epochs from ``epoch + 1``, a full checkpoint at
    each ``eval_interval`` and at the last epoch, a log line with each;
    returns the last epoch's stats, and NaN stats when nothing is left."""
    cfg = _config(render_mode="uniform", num_steps=16, num_rays=64,
                  num_rays_lidar=64, epochs=3, eval_interval=2,
                  flow_loss=False, use_urf_loss=False,
                  log2_hashmap_size=10, min_resolution=8,
                  workspace=str(tmp_path), name="tr", **SMALL)
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"), device="cpu")
    lines = []
    stats = tr.train(log_fn=lines.append)
    assert tr.epoch == 3 and tr.global_step == 3 * len(tr.scene)
    assert np.isfinite(stats.loss) and set(stats.parts) >= {"loss", "rgb"}
    ckpts = sorted(os.listdir(tmp_path / "checkpoints"))
    assert ckpts == ["tr_ep0002.pkl", "tr_ep0003.pkl"], ckpts
    with open(tmp_path / "checkpoints" / "tr_ep0003.pkl", "rb") as f:
        raw = pickle.load(f)
    assert raw["epoch"] == 3 and raw["opt_state_torch"] is not None
    assert raw["error_map"] is not None
    assert [ln.split("]")[0] for ln in lines] == ["[epoch 2", "[epoch 3"]
    assert f"loss={stats.loss:.5f}" in lines[-1]
    again = tr.train(log_fn=lines.append)
    assert np.isnan(again.loss) and tr.epoch == 3 and len(lines) == 2


# ----------------------------------------------------------------------
# the CLI and the quality-protocol script
# ----------------------------------------------------------------------

def test_cli_uniform_train_then_test(tmp_path):
    """The JAX CLI test's argv (``tests/test_cli.py:37-60``, no
    ``--render_mode``: the uniform default) through the port's CLI on the
    CPU: training with its eval, checkpoints, trace, refine and refined
    eval; then ``--test`` from the latest checkpoint with the mesh."""
    from nvsf_torch.scripts.main_nvsf import main as cli_main
    ws = str(tmp_path / "ws")
    argv = [
        "--dataloader", "synthetic", "--path", "unused",
        "--sequence_id", "syn",
        "--num_frames", "4", "--scale", "0.04",
        "--lidar_max_depth", "20", "--min_near_lidar", "0.5",
        "--intrinsics_lidar", "10.0", "40.0",
        "--intrinsics_hoz_lidar", "180.0", "360.0",
        "--enable_lidar",
        "--epochs", "2", "--eval_interval", "2",
        "--num_rays_lidar", "128", "--num_steps", "32",
        "--max_ray_batch", "256",
        "--min_resolution", "8", "--n_levels_plane", "2",
        "--base_resolution", "16", "--max_resolution", "64",
        "--time_resolution", "4", "--n_levels_hash", "2",
        "--log2_hashmap_size", "10",
        "--flow_n_levels", "2", "--flow_log2_hashmap_size", "6",
        "--flow_base_resolution", "8", "--flow_max_resolution", "16",
        "--workspace", ws, "--ckpt", "scratch", "--name", "smoke",
        "--refine_steps", "5",
        "--profile_dir", str(tmp_path / "trace"),
    ]
    tr = cli_main(argv, device="cpu")
    assert tr.cfg.render_mode == "uniform" and tr.occ is None
    assert tr.has_unet and tr.epoch == 2
    assert [p for p in (tmp_path / "trace").rglob("*") if p.is_file()]
    for stage in ("train epoch", "eval ep0002", "refine render",
                  "refine unet", "refined eval"):
        assert tr.timers.counts[stage] >= 1, stage
    val = os.listdir(os.path.join(ws, "validation"))
    assert "smoke_ep0002_error_matrix_combined.json" in val
    assert "smoke_ep0002_refined_error_matrix_combined.json" in val

    test_argv = [a for a in argv if a != "--profile_dir"
                 and not a.startswith(str(tmp_path / "trace"))]
    test_argv += ["--test", "--mesh_xyz_res", "24", "24", "12"]
    test_argv[test_argv.index("scratch")] = "latest"
    tt = cli_main(test_argv, device="cpu")
    assert tt.occ is None
    files = os.listdir(os.path.join(ws, "results"))
    for suffix in ("_depth.png", "_pcd_lidar.txt", "_pcd_world.txt",
                   "_lidar.pcd"):
        assert any(f.endswith(suffix) for f in files), suffix
    assert "smoke_mesh.ply" in files
    assert any(f.endswith(".pkl")
               for f in os.listdir(os.path.join(ws, "checkpoints")))
    assert os.path.exists(os.path.join(ws, "log_smoke.txt"))


def test_quality_run_script_prints_its_records(capsys):
    """``python -m nvsf_torch.scripts.quality_run`` at a tiny size (64 rays
    with K 8, the eval at another K 16): the device line, then one JSON
    line per epoch and per eval with the JAX tool's keys, finite."""
    from nvsf_torch.scripts import quality_run
    quality_run.main(["--epochs", "1", "--eval-every", "1", "--device",
                      "cpu", "--rays", "64", "--occ-K", "8", "--eval-K",
                      "16"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    recs = [json.loads(ln) for ln in lines[1:]]
    assert len(recs) == 2
    assert set(recs[0]) == {"shape", "seed", "epoch", "loss", "t"}
    ev = recs[1]
    assert set(ev) == {"shape", "seed", "epoch", "train_loss", "CD", "F",
                       "depth_RMSE", "raydrop_acc", "PSNR", "SSIM", "t"}
    assert (ev["shape"], ev["seed"], ev["epoch"]) == ("flow-4x32", 0, 1)
    for k in ("train_loss", "depth_RMSE", "raydrop_acc", "PSNR", "SSIM"):
        assert np.isfinite(ev[k]), (k, ev)
