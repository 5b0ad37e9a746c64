"""Whole-step parity: one patch step (with the shipped config's
``grad_loss``) and one random step of the port's joint LiDAR + camera
trainer against the JAX trainer, from the same bridged state and the same
random draws, on the CPU in f32; the patch structural regularizers and the
color conversions on their own; checkpoints written by either package and
read by the other, and one step after resuming from a JAX checkpoint.

The JAX draws are rebuilt by replaying the key splits of the JAX step
(``trainer.py:385``), its samplers (``sampler.py``) and its renderer
(``renderer.py:318,325``), and handed to the port through ``draws``.

Tolerances: the losses agree to rtol 1e-4 and every parameter gradient to
atol 1e-4 x max|JAX gradient| (f32 transcendentals and summation orders
differ between XLA and PyTorch at the ulp level, and the step sums a few
hundred thousand such terms; a gradient is compared per parameter against
its own scale because the tables' gradients are orders of magnitude
smaller than the MLPs').
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvsf_tpu.config import NVSFConfig
from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nvsf_tpu.train.trainer import Trainer as JaxTrainer
from nvsf_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvsf_torch import bridge
from nvsf_torch.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_torch.train.trainer import Trainer, make_optimizer, zero_nan_grads

from test_torch_models import one_torch_thread  # noqa: F401
from torch_mesh_ranks import (np_camera_rays, np_lidar_rays,
                              torch_camera_rays, torch_lidar_rays)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = dict(num_frames=4, H_lidar=24, W_lidar=64, H=32, W=40,
            max_depth=80.0, scale=1.0 / 81.0)


def _config(**over):
    """The SKILL drive's toy config with flow and URF losses on. The grids
    stop at resolution 256: the two frameworks' sin / cos differ by an ulp
    in a few ray directions, which moves a sample by ~1e-7 of the scene;
    at resolution r that shifts ~1e-7 * r of its corner weights between
    table entries, so the finest level must keep r * 1e-7 well below the
    gradient tolerance (at the default 32768 it would not)."""
    s = SPEC["scale"]
    d = dict(enable_lidar=True, enable_rgb=True, num_frames=4, scale=s,
             bound=1.0, min_near_lidar=1.0 * s, lidar_max_depth=80.0 * s,
             min_near=1.0 * s, active_sensor=True, num_rays=256,
             num_rays_lidar=256, num_steps=64, num_steps_occ=32,
             render_mode="occupancy", log2_hashmap_size=14, n_levels_hash=4,
             n_features_per_level_hash=8, flow_n_levels=4,
             base_resolution=16, max_resolution=256,
             flow_base_resolution=16, flow_max_resolution=256, iters=100,
             epochs=12, use_error_map=True, flow_loss=True,
             use_urf_loss=True, occ_grid_size=32)
    d.update(over)
    return NVSFConfig.from_dict(d)


def _jax_draws(jtr, state, fi, patch):
    """The random draws of one JAX step, as the port's ``draws`` dict."""
    cfg, scene = jtr.cfg, jtr.scene
    _key, k_li, k_ci, k_pl, k_pc, _k_bg = jax.random.split(state["key"], 6)
    t = lambda a: torch.as_tensor(np.asarray(a))

    def rays(k, N, H, W, em, ph_pw):
        if ph_pw[0] > 1:   # patch epochs sample with the error map
            num_patch = N // (ph_pw[0] * ph_pw[1])
            k_sel, k_jx, k_jy = jax.random.split(k, 3)
            d = {"ux": t(jax.random.uniform(k_jx, (num_patch,))),
                 "uy": t(jax.random.uniform(k_jy, (num_patch,)))}
            d["gumbel"] = t(jax.random.gumbel(k_sel, (em.size,)))
            return d
        if patch:          # error-map sampling without patches
            k_sel, k_jx, k_jy = jax.random.split(k, 3)
            d = {"ux": t(jax.random.uniform(k_jx, (N,))),
                 "uy": t(jax.random.uniform(k_jy, (N,)))}
            logw = jnp.log(jnp.maximum(jnp.asarray(em).reshape(-1), 1e-12))
            if N > em.size:
                d["coarse"] = t(jax.random.categorical(k_sel, logw,
                                                       shape=(N,)))
            else:
                d["gumbel"] = t(jax.random.gumbel(k_sel, (em.size,)))
            return d
        return {"inds": t(jax.random.randint(k, (N,), 0, H * W, jnp.int32))}

    def render(k, N, K):
        k, kz = jax.random.split(k)
        _k, kj = jax.random.split(k)
        return {"z_noise": t(jax.random.uniform(kz, (N, cfg.num_steps))),
                "jitter_u": t(jax.random.uniform(kj, (N, K)))}

    ph_pw = tuple(cfg.change_patch_size_lidar) if patch else (1, 1)
    return {
        "lidar_rays": rays(k_li, cfg.num_rays_lidar, scene.H_lidar,
                           scene.W_lidar, np.asarray(state["error_map"][fi]),
                           ph_pw),
        "rgb_rays": rays(k_ci, cfg.num_rays, scene.H, scene.W,
                         np.asarray(state["error_map_rgb"][fi]), (1, 1)),
        "lidar_render": render(k_pl, cfg.num_rays_lidar, cfg.num_steps_occ),
        "rgb_render": render(k_pc, cfg.num_rays,
                             cfg.num_steps_occ_rgb or cfg.num_steps_occ),
    }


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    cfg = _config(grad_loss=True)
    jtr = JaxTrainer(cfg, jax_scene(JaxSceneSpec(**SPEC), split="train"),
                     workspace=str(tmp_path_factory.mktemp("jax_ws")))
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"), device="cpu")
    rng = np.random.default_rng(0)
    state = dict(jtr.state)
    # non-trivial error maps and an occupancy grid with an empty half-space
    # (a smooth pattern: a random grid would let ulp-level differences in
    # the sample positions flip cells)
    state["error_map"] = jnp.asarray(
        rng.uniform(1, 100, state["error_map"].shape).astype(np.float32))
    state["error_map_rgb"] = jnp.asarray(
        rng.uniform(1, 100, state["error_map_rgb"].shape).astype(np.float32))
    G = cfg.occ_grid_size
    grid = np.full((G, G, G), 32.0, np.float32)
    grid[:, :, :G // 2 - 3] = 0.0
    state["occ_grid_lidar"] = state["occ_grid_rgb"] = jnp.asarray(grid)
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, state))
    return cfg, jtr, state, tr


def _jax_step(jtr, state, fi, patch):
    """The JAX step with an optimizer that records the gradients (the new
    state's ``opt_state``); compiled once per trainer and mode."""
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    steps = jtr.__dict__.setdefault("_recording_steps", {})
    if patch not in steps:
        jtr.tx = record
        steps[patch] = jax.jit(jtr._make_train_step(patch))
    st = dict(state, opt_state=record.init(state["params"]))
    return steps[patch](st, jnp.int32(fi))


def _check_error_map(em_old, em_new_ref, em_new, inds, err, H, W):
    """Equal to JAX where one ray wrote a cell (rtol 1e-3: a per-ray loss
    near the batch minimum is normalized by a difference of two sums);
    where several rays did, which write lands is unspecified in both
    frameworks, so the port's value must be one of theirs."""
    He, We = em_old.shape
    ey = ((inds // W).astype(np.float32) * (He / H)).astype(np.int64)
    ex = ((inds % W).astype(np.float32) * (We / W)).astype(np.int64)
    cell = ey * We + ex
    uniq, counts = np.unique(cell, return_counts=True)
    once = np.zeros(He * We, bool)
    once[uniq[counts == 1]] = True
    untouched = np.ones(He * We, bool)
    untouched[uniq] = False
    old, ref, got = (a.reshape(-1) for a in (em_old, em_new_ref, em_new))
    np.testing.assert_allclose(got[once], ref[once], rtol=1e-3)
    np.testing.assert_array_equal(got[untouched], old[untouched])
    e = (err - err.min()) / (err.max() - err.min()
                             + np.finfo(np.float32).eps) * (1e3 - 1) + 1
    for c in uniq[counts > 1]:
        cand = 0.1 * old[c] + 0.9 * e[cell == c]
        assert np.isclose(cand, got[c], rtol=1e-5).any(), c


def _shared_rays(monkeypatch):
    """Both trainers take their rays from one numpy function (through a
    host callback in the JAX step): sin / cos differ by an ulp between the
    frameworks, and the degree-12 frequency encoding of the view direction
    (up to 2^11 * pi rad) magnifies that to ~1e-3 in the LiDAR heads'
    inputs. Ray parity itself is tested in test_torch_models.py."""
    from nvsf_torch.lib import rays as trays
    from nvsf_tpu.lib import rays as jrays

    def jax_side(np_fn):
        def call(pose, inds, *args):
            out = jax.ShapeDtypeStruct((inds.shape[0], 3), jnp.float32)
            return jax.pure_callback(
                lambda p, i, *a: np_fn(np.asarray(p), np.asarray(i),
                                       *args[:2], *a),
                (out, out), pose, inds, *args[2:])
        return call

    monkeypatch.setattr(jrays, "get_lidar_rays", jax_side(np_lidar_rays))
    monkeypatch.setattr(jrays, "get_camera_rays", jax_side(np_camera_rays))
    monkeypatch.setattr(trays, "get_lidar_rays", torch_lidar_rays)
    monkeypatch.setattr(trays, "get_camera_rays", torch_camera_rays)


@pytest.mark.parametrize("patch", [True, False], ids=["patch", "random"])
def test_step_matches_jax(pair, patch, monkeypatch):
    cfg, jtr, state, tr = pair
    _shared_rays(monkeypatch)
    fi = 1
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
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert set(parts) == {"loss_d", "loss_i", "loss_rd", "chamfer", "flow",
                          "urf", "rgb"} | ({"loss_sr"} if patch else set())
    for name, p in tr.field.named_parameters():
        ref = jgrads[name]
        got = torch.zeros_like(p) if p.grad is None else p.grad
        scale = max(float(np.abs(ref).max()), 1e-12)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale, err_msg=name)

    # the error-map update of the step
    from nvsf_torch.data import sampler
    inds, err = em_in["lidar"]
    em1 = sampler.update_error_map(em0, inds, err, tr.scene.H_lidar,
                                   tr.scene.W_lidar)
    _check_error_map(em0.numpy(), np.asarray(new_state["error_map"][fi]),
                     em1.numpy(), inds.numpy(), err.numpy(),
                     tr.scene.H_lidar, tr.scene.W_lidar)


def test_optimizer_matches_optax():
    """Three Adam steps on the same gradients (one with a NaN) move the
    port's parameters as the optax chain of ``make_optimizer`` does; the
    slow group runs at 0.1x and the decay follows the step count."""
    cfg = _config(iters=4, lr=1e-2)
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"), device="cpu")
    tree = bridge.field_to_tree(tr.field)
    from nvsf_tpu.train.trainer import field_spec_from_config
    tx = jax_make_optimizer(cfg, field_spec_from_config(cfg), tree)
    jparams = jax.tree.map(jnp.asarray, tree)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    opt, sched = make_optimizer(cfg, tr.field)
    rng = np.random.default_rng(3)
    params = dict(tr.field.named_parameters())
    for step in range(3):
        g = {k: (rng.standard_normal(p.shape)
                 * 10.0 ** rng.integers(-6, 0)).astype(np.float32)
             for k, p in params.items()}
        g["sigma_net.0"][0, 0] = np.nan
        gtree = bridge.tree_from_params({k: torch.as_tensor(v)
                                         for k, v in g.items()})
        upd, opt_state = update(jax.tree.map(jnp.asarray, gtree),
                                opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in params.items():
            p.grad = torch.as_tensor(g[k]).clone()
        zero_nan_grads(params.values())
        opt.step()
        sched.step()
    ref = bridge.flatten_tree(jax.tree.map(np.asarray, jparams))
    start = bridge.flatten_tree(tree)
    for k, p in params.items():
        # against the distance moved: Adam's first steps are ~lr * sign(g)
        moved = np.abs(ref[k] - start[k]).max()
        np.testing.assert_allclose(p.detach().numpy(), ref[k], rtol=0,
                                   atol=1e-4 * max(moved, 1e-12), err_msg=k)


def test_far_plane_truncation_guard():
    with pytest.raises(ValueError, match="truncates the GT depth"):
        Trainer(_config(lidar_max_depth=80.0 * SPEC["scale"] ** 2),
                make_synthetic_scene(SyntheticSceneSpec(**SPEC)),
                device="cpu")


# ----------------------------------------------------------------------
# the patch structural regularizers and the color conversions
# ----------------------------------------------------------------------

_SR_CASES = {
    "grad_norm_smooth": dict(grad_norm_smooth=True),
    "spatial_smooth": dict(spatial_smooth=True),
    "tv_loss": dict(tv_loss=True),
    "grad_loss": dict(grad_loss=True),
    "grad_loss-sobel": dict(grad_loss=True, sobel_grad=True),
    "grad_loss-cos": dict(grad_loss=True, depth_grad_loss_is_cos=True),
    "all-sobel-cos": dict(grad_norm_smooth=True, spatial_smooth=True,
                          tv_loss=True, grad_loss=True, sobel_grad=True,
                          depth_grad_loss_is_cos=True),
}


@pytest.mark.parametrize("case", list(_SR_CASES))
def test_structural_regularizers_match_jax(case):
    """The loss and its gradient in the rendered depth patches, on random
    [8, 2, 8] patches (the shipped patch shape) in meters, to rtol 1e-5
    (f32 sums of a few hundred terms)."""
    from nvsf_tpu.train import losses as JL
    from nvsf_torch.train import losses as TL
    flags = dict(alpha_grad_norm=0.1, alpha_spatial=0.2, alpha_tv=0.3,
                 alpha_grad=0.4, **_SR_CASES[case])
    crit = "cos" if flags.get("depth_grad_loss_is_cos") else "l1"
    rng = np.random.default_rng(5)
    pd, gd = (rng.uniform(1, 40, (8, 2, 8)).astype(np.float32)
              for _ in range(2))
    grd, gmx, gmy = ((rng.uniform(size=(8, 2, 8)) > 0.3).astype(np.float32)
                     for _ in range(3))
    rest = [jnp.asarray(a) for a in (gd, grd, gmx, gmy)]
    ref, ref_g = jax.value_and_grad(lambda p: JL.structural_regularizers(
        p, *rest, JL.make_criterion(crit), flags))(jnp.asarray(pd))
    p = torch.from_numpy(pd).requires_grad_(True)
    got = TL.structural_regularizers(
        p, *(torch.from_numpy(a) for a in (gd, grd, gmx, gmy)),
        TL.make_criterion(crit), flags)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref_g), rtol=1e-5,
                               atol=1e-6 * float(np.abs(ref_g).max()))


def test_pano_double_gradients_and_color_match_jax():
    """GT-pano double gradients (one pano as the JAX step takes it, a batch
    as the port's trainer does) exactly, and the sRGB <-> linear
    conversions to rtol 1e-6."""
    from nvsf_tpu.lib import color as jcolor
    from nvsf_tpu.train import losses as JL
    from nvsf_torch.lib import color as tcolor
    from nvsf_torch.train import losses as TL
    rng = np.random.default_rng(6)
    panos = rng.uniform(0, 0.8, (3, 16, 48)).astype(np.float32)
    got = TL.pano_double_gradients(torch.from_numpy(panos), 1 / 81)
    for i in range(3):
        ref = JL.pano_double_gradients(jnp.asarray(panos[i]), 1 / 81)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))
    x = rng.uniform(-0.2, 1.2, 4096).astype(np.float32)
    for fn in ("srgb_to_linear", "linear_to_srgb"):
        np.testing.assert_allclose(
            getattr(tcolor, fn)(torch.from_numpy(x)).numpy(),
            np.asarray(getattr(jcolor, fn)(jnp.asarray(x))), rtol=1e-6,
            atol=1e-7, err_msg=fn)


def test_shipped_config_trains_a_patch_epoch(tmp_path):
    """configs/kitti360_1908.txt builds a trainer (its grad_loss, flow
    loss, error map, bf16 and use_refine flags all on; only the table
    sizes, ray counts and sample budgets cut for the CPU) whose patch epoch
    adds a finite, non-zero structural term."""
    from nvsf_torch.config import load_config
    cfg = load_config([
        "--config", os.path.join(REPO, "configs", "kitti360_1908.txt"),
        "--num_frames", "4", "--lidar_max_depth", "30",
        "--log2_hashmap_size", "12", "--flow_log2_hashmap_size", "10",
        "--num_rays", "64", "--num_rays_lidar", "64", "--num_steps", "32",
        "--num_steps_occ", "8", "--num_steps_occ_rgb", "8",
        "--occ_grid_size", "16", "--workspace", str(tmp_path)])
    assert cfg.grad_loss and cfg.flow_loss and cfg.fp16 and cfg.use_refine
    cfg = cfg.finalize(steps_per_epoch=3)
    scene = make_synthetic_scene(SyntheticSceneSpec(num_frames=4,
                                                    scale=cfg.scale))
    tr = Trainer(cfg, scene, device="cpu")
    tr.epoch = 2
    st = tr.train_one_epoch(order=[0, 1])
    assert np.isfinite(st.loss) and st.parts["loss_sr"] > 0, st.parts


# ----------------------------------------------------------------------
# checkpoints across the packages
# ----------------------------------------------------------------------

def _tree_equal(a, b):
    for k, v in bridge.flatten_tree(a).items():
        np.testing.assert_array_equal(np.asarray(v),
                                      bridge.flatten_tree(b)[k], err_msg=k)


def test_port_checkpoint_loads_in_jax(pair, tmp_path, monkeypatch):
    """A full checkpoint of the port, after a real step, read by
    ``nvsf_tpu``'s ``Trainer.load_checkpoint``: params, EMA, U-Net and its
    stats, grids, error maps, epoch and step arrive bit for bit; the JAX
    optimizer state is left as it was (the port writes only
    ``opt_state_torch``)."""
    cfg, jtr, state, tr = pair
    _shared_rays(monkeypatch)
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, state))
    tr.train_step(1, False, _jax_draws(jtr, state, 1, False))
    tr.epoch, tr.unet_trained = 3, True
    tr.workspace = str(tmp_path)
    path = tr.save_checkpoint(full=True)
    payload = bridge.export_trainer_state(tr)
    saved = dict(jtr.state)
    try:
        assert jtr.load_checkpoint(path)
        _tree_equal(jtr.state["params"], payload["model"])
        _tree_equal(jtr.state["ema_params"], payload["ema"])
        _tree_equal(jtr.state["unet_params"], payload["unet"])
        _tree_equal(jtr.state["unet_stats"], payload["unet_stats"])
        for k in ("error_map", "error_map_rgb", "occ_grid_lidar",
                  "occ_grid_rgb"):
            np.testing.assert_array_equal(np.asarray(jtr.state[k]),
                                          payload[k], err_msg=k)
        assert (jtr.epoch, jtr.global_step, jtr.unet_trained) \
            == (3, tr.global_step, True)
        assert jtr.state["opt_state"] is saved["opt_state"]
    finally:
        jtr.state = saved


def test_step_after_resume_from_jax_checkpoint_matches_jax(pair, tmp_path,
                                                           monkeypatch):
    """The JAX trainer takes one real step and writes a full checkpoint;
    the port resumes from it (optax's Adam moments and count become
    torch's, the schedule goes to the global step) and both take the next
    step on the same draws. The port's parameters then match the JAX
    step's to 1e-4 of the distance each parameter moved, plus what the
    gradients' own tolerance (1e-4 of their scale, test_step_matches_jax)
    becomes after Adam's step: dg * (1 - b1) / (1 - b1^2) / sqrt(nu_hat)
    of the move, large only where an entry's gradient is tiny against
    its parameter's scale."""
    from nvsf_tpu.train.trainer import field_spec_from_config
    cfg, jtr, state, tr = pair
    _shared_rays(monkeypatch)
    fi = 1
    tx = jax_make_optimizer(cfg, field_spec_from_config(cfg),
                            state["params"])
    update = jax.jit(tx.update)

    def real_step(st):
        new, _ = _jax_step(jtr, st, fi, False)
        upd, opt = update(new["opt_state"], st["opt_state"], st["params"])
        return dict(new, params=optax.apply_updates(st["params"], upd),
                    opt_state=opt, grads=new["opt_state"])

    state0 = dict(state, opt_state=tx.init(state["params"]))
    state1 = real_step(state0)
    saved = dict(jtr.state)
    jtr.state, jtr.epoch, jtr.global_step = state1, 1, 1
    jtr.workspace = str(tmp_path)
    try:
        path = jtr.save_checkpoint(full=True)
    finally:
        jtr.state = saved
    assert tr.load_checkpoint(path)
    assert tr.global_step == 1 and tr.epoch == 1
    count, mu, nu = state1["opt_state"][1]
    adam = tr.optimizer.state
    for k, p in tr.field.named_parameters():
        np.testing.assert_array_equal(adam[p]["exp_avg"].numpy(),
                                      bridge.flatten_tree(mu)[k])
        np.testing.assert_array_equal(adam[p]["exp_avg_sq"].numpy(),
                                      bridge.flatten_tree(nu)[k])
        assert int(adam[p]["step"]) == int(count) == 1
    assert tr.optimizer.param_groups[0]["lr"] == pytest.approx(
        cfg.lr * 0.1 ** (1 / cfg.iters), rel=1e-6)

    # the next step on the first step's draws: the same table entries
    # are touched, so none meets Adam with an empty second moment
    state1_in = dict(state1, key=state["key"])
    draws = _jax_draws(jtr, state1_in, fi, False)
    state2 = real_step(state1_in)
    tr.train_step(fi, False, draws)
    ref, start, grads, nu = (
        bridge.flatten_tree(jax.tree.map(np.asarray, t)) for t in (
            state2["params"], state1["params"], state2["grads"],
            state2["opt_state"][1].nu))
    for k, p in tr.field.named_parameters():
        moved = np.abs(ref[k] - start[k]).max()
        dg = 1e-4 * np.abs(grads[k]).max()
        amplify = (0.1 / (1 - 0.9 ** 2)) * dg \
            / (np.sqrt(nu[k] / (1 - 0.99 ** 2)) + 1e-15)
        np.testing.assert_array_less(np.abs(p.detach().numpy() - ref[k]),
                                     moved * (1e-4 + amplify) + 1e-12,
                                     err_msg=k)
