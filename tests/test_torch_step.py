"""Whole-step parity: one patch step and one random step of the port's
joint LiDAR + camera trainer against the JAX trainer, from the same bridged
state and the same random draws, on the CPU in f32.

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
    cfg = _config()
    jtr = JaxTrainer(cfg, jax_scene(JaxSceneSpec(**SPEC), split="train"),
                     workspace=str(tmp_path_factory.mktemp("jax_ws")))
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"))
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
    """The JAX step with an optimizer that records the gradients."""
    record = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    jtr.tx = record
    st = dict(state, opt_state=record.init(state["params"]))
    new_state, metrics = jax.jit(jtr._make_train_step(patch))(
        st, jnp.int32(fi))
    return new_state, metrics


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


def _np_lidar_rays(pose, inds, H, W, K, K_hoz):
    fov_up, fov = K
    j = (inds // W).astype(np.float32)
    i = (inds % W).astype(np.float32)
    beta = -(i - W / 2) / W * np.float32(K_hoz[1]) / 180 * np.float32(np.pi)
    alpha = (np.float32(fov_up) - j / H * np.float32(fov)) / 180 \
        * np.float32(np.pi)
    d = np.stack([np.cos(alpha) * np.cos(beta), np.cos(alpha) * np.sin(beta),
                  np.sin(alpha)], -1).astype(np.float32)
    return _np_pose_rays(pose, d)


def _np_camera_rays(pose, inds, H, W, K):
    j = (inds // W).astype(np.float32) + 0.5
    i = (inds % W).astype(np.float32) + 0.5
    d = np.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                  np.ones_like(i)], -1).astype(np.float32)
    return _np_pose_rays(pose, d / np.linalg.norm(d, axis=-1, keepdims=True))


def _np_pose_rays(pose, d):
    pose = np.asarray(pose, np.float32)
    rd = (d @ pose[:3, :3].T).astype(np.float32)
    return np.broadcast_to(pose[:3, 3], rd.shape).copy(), rd


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

    def torch_side(np_fn):
        def call(pose, inds, *args):
            args = [a.numpy() if torch.is_tensor(a) else a for a in args]
            ro, rd = np_fn(pose.numpy(), inds.numpy(), *args)
            return torch.from_numpy(ro), torch.from_numpy(rd)
        return call

    monkeypatch.setattr(jrays, "get_lidar_rays", jax_side(_np_lidar_rays))
    monkeypatch.setattr(jrays, "get_camera_rays", jax_side(_np_camera_rays))
    monkeypatch.setattr(trays, "get_lidar_rays", torch_side(_np_lidar_rays))
    monkeypatch.setattr(trays, "get_camera_rays",
                        torch_side(_np_camera_rays))


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
                          "urf", "rgb"}
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
                                           split="train"))
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
                make_synthetic_scene(SyntheticSceneSpec(**SPEC)))
