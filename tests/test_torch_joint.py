"""The port's joint LiDAR + camera path (``joint_fusion``) against the JAX
package and against the port's own separate path, on the CPU in f32, at
the ``TINY`` sizes of ``tests/test_joint.py``: the joint encoders,
``NVSFField.density_joint``, ``Renderer.run_joint`` (dense and occupancy,
the JAX draws injected), one whole ``Trainer`` step, and the trainer's
guards.

Tolerances: ``density_joint`` holds JAX's own joint-vs-separate
tolerances (sigma rtol 2e-5, geo_feat rtol 2e-4, flow rtol 2e-5) against
JAX's ``density_joint`` and against the port's two ``density`` calls; the
joint and separate paths' gradients agree within 1e-5 of each gradient's
largest magnitude (the same per-point functions, summed in another order);
renders and the step hold the port's JAX tolerances of
``tests/test_torch_models.py`` and ``tests/test_torch_step.py`` (forward
rtol 1e-4 / atol 1e-5, gradients 1e-4 of each parameter's largest
gradient, losses rtol 1e-4), with two exceptions, each measured:

- the jitted JAX render of the occupancy case contracts the jitter's
  multiply-add, which moves a depth by an ulp; a depth an ulp across a
  K-plane cell edge jumps the warped lookup's slope, which the flow
  field's gradient carries, so that case compares every gradient but the
  flow field's (the dense case, run eagerly, holds all of them, and the
  port's joint render equals its separate render, flow included);
- the whole step: a handful of the step's samples have a sigma-net
  hidden unit whose pre-activation lies within f32 rounding of zero (on
  this state one camera sample's comes out negative in the port and
  positive in JAX), so the ReLU passes that unit's gradient in one
  framework and not in the other, and the sample's encoder entries
  differ by up to ~1e-3 of their tensor's largest gradient. The test records the samples
  with a pre-activation within 1e-6 of zero and lets an entry depart from
  JAX beyond 1e-4 (up to 2e-3) only where those samples' own gradient
  reaches; everything else holds 1e-4. The port's joint step equals its
  separate step to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu.models.field import NVSFFieldSpec
from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.render.renderer import RendererSpec
from nvsf_torch import bridge
from nvsf_torch.models.field import FieldSpec, NVSFField
from nvsf_torch.models.hash_grid import HashGrid4D
from nvsf_torch.models.planes import Planes4D
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.render.renderer import Renderer

from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_step import (SPEC, _config, _jax_draws, _jax_step,
                             _shared_rays)

TINY = dict(min_resolution=8, n_levels_plane=2, base_resolution=16,
            max_resolution=64, n_levels_hash=3, n_features_per_level_hash=4,
            log2_hashmap_size=10, flow_n_levels=3,
            flow_n_features_per_level=8, flow_log2_hashmap_size=10,
            num_frames=6, bound=1.0)
FWD = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def fields():
    """The JAX TINY field and its bridged port, the weights perturbed from
    the init so that the time planes (ones at init) pass gradient to the
    warped positions, i.e. to the flow field."""
    jspec = NVSFFieldSpec(**TINY)
    tree = jax.tree.map(np.asarray, jspec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.1
                   * max(float(np.abs(a).max()), 1e-3)).astype(np.float32),
        tree)
    field = NVSFField(FieldSpec(**TINY))
    bridge.load_field(field, tree)
    return jspec, jax.tree.map(jnp.asarray, tree), field


def _points(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)) \
        .astype(np.float32)


def _grads(field):
    return {k: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
            for k, p in field.named_parameters()}


def _assert_grads_close(got, ref, rel):
    for k, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_allclose(
            np.asarray(got[k]), r, rtol=0, err_msg=k,
            atol=rel * max(float(np.abs(r).max()), 1e-12))


def test_joint_encoders_match_separate(fields):
    """Each branch of the joint encoders equals that branch's own call:
    the static hash (one gather, tables side by side), the three-query
    dynamic hash (gradient only through the t-rows), and the static and
    dynamic K-planes (segments ordered branch, scale, plane) on
    branches of different lengths, compared branch by branch."""
    _, _, field = fields
    hashes = [field.hash_lidar, field.hash_camera]
    planes = [field.planes_lidar, field.planes_camera]
    x = [(torch.from_numpy(_points(s, n)) + 1) / 2
         for s, n in ((1, 40), (2, 24))]
    t, t1, t2 = (torch.tensor(v) for v in (0.4, 0.5, 0.1))
    for got, h, xi in zip(HashGrid4D.apply_static_joint(hashes, x), hashes,
                          x):
        np.testing.assert_allclose(got.detach().numpy(),
                                   h.apply_static(xi).detach().numpy(),
                                   rtol=1e-6, atol=1e-9)
    qs = [(xi, xi + 0.01, xi - 0.02) for xi in x]
    for got, h, q in zip(HashGrid4D.apply_dynamic_fused3_joint(
            hashes, qs, t, t1, t2), hashes, qs):
        for g, r in zip(got, h.apply_dynamic_fused3(*q, t, t1, t2)):
            np.testing.assert_allclose(g.detach().numpy(),
                                       r.detach().numpy(), rtol=1e-6,
                                       atol=1e-9)
    xt = [torch.cat([xi, torch.full((len(xi), 1), 0.4)], -1) for xi in x]
    for got, p, xi in zip(Planes4D.apply_static_joint(planes, xt), planes,
                          xt):
        np.testing.assert_allclose(got.detach().numpy(),
                                   p.apply_static(xi).detach().numpy(),
                                   rtol=1e-6, atol=1e-9)
    xts = [torch.stack([xi, xi.flip(0), xi * 0.9]) for xi in xt]
    for got, p, xi in zip(Planes4D.apply_dynamic_multi_branches(planes, xts),
                          planes, xts):
        np.testing.assert_allclose(
            got.detach().numpy(), p.apply_dynamic_multi(xi).detach().numpy(),
            rtol=1e-6, atol=1e-9)


def test_density_joint_matches_jax_and_separate(fields):
    jspec, params, field = fields
    x_l, x_c, xe = _points(3, 40), _points(4, 24), _points(5, 16)
    t = 0.37
    ref = jspec.density_joint(params, *map(jnp.asarray, (x_l, x_c)), t,
                              x_flow_extra=jnp.asarray(xe))
    with torch.no_grad():
        dj = field.density_joint(*map(torch.from_numpy, (x_l, x_c)),
                                 torch.tensor(t),
                                 x_flow_extra=torch.from_numpy(xe))
        sep = {"_l": field.density(torch.from_numpy(x_l), torch.tensor(t),
                                   cal_lidar_color=True),
               "_c": field.density(torch.from_numpy(x_c), torch.tensor(t))}
        fe = field.flow_at(torch.from_numpy(xe), torch.tensor(t))
    tol = {"sigma": dict(rtol=2e-5, atol=1e-6),
           "geo_feat": dict(rtol=2e-4, atol=1e-5)}
    for sfx in ("_l", "_c"):
        for k in ("sigma", "geo_feat"):
            got = dj[k + sfx].numpy()
            np.testing.assert_allclose(got, np.asarray(ref[k + sfx]),
                                       err_msg=k + sfx, **tol[k])
            np.testing.assert_allclose(got, sep[sfx][k].numpy(),
                                       err_msg=k + sfx, **tol[k])
    for k in ("flow_forward", "flow_backward"):
        np.testing.assert_allclose(dj["flow_extra"][k].numpy(),
                                   np.asarray(ref["flow_extra"][k]),
                                   rtol=2e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(dj["flow_extra"][k].numpy(),
                                   fe[k].numpy(), rtol=2e-5, atol=1e-7)


def test_density_joint_gradients_match_separate(fields):
    """The JAX package marks its version of this check slow; here it runs
    at the TINY size in tier-1. Every parameter's gradient of the joint
    loss equals the separate path's within 1e-5 of its largest value."""
    _, _, field = fields
    x_l, x_c = (torch.from_numpy(_points(s, n)) for s, n in ((6, 40),
                                                           (7, 24)))
    t = torch.tensor(0.61)
    field.zero_grad(set_to_none=True)
    a = field.density(x_l, t, cal_lidar_color=True)
    b = field.density(x_c, t)
    (a["sigma"].sum() + 2 * b["sigma"].sum() + (a["geo_feat"] ** 2).sum()
     + (b["geo_feat"] ** 2).sum()).backward()
    sep = _grads(field)
    field.zero_grad(set_to_none=True)
    d = field.density_joint(x_l, x_c, t)
    (d["sigma_l"].sum() + 2 * d["sigma_c"].sum()
     + (d["geo_feat_l"] ** 2).sum()
     + (d["geo_feat_c"] ** 2).sum()).backward()
    joint = _grads(field)
    assert float(sep["flow.grid"].abs().max()) > 0     # flow is driven
    _assert_grads_close(joint, sep, 1e-5)


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    ro = np.tile(np.array([[0.02, -0.01, 0.02]], np.float32), (n, 1))
    rd = rng.standard_normal((n, 3)).astype(np.float32)
    return ro, rd / np.linalg.norm(rd, axis=-1, keepdims=True)


@pytest.mark.parametrize("occupancy", [False, True],
                         ids=["dense", "occupancy"])
def test_run_joint_matches_jax(fields, occupancy):
    """``run_joint`` with the JAX draws of its key injected: outputs and
    parameter gradients against JAX's ``run_joint``, and outputs against
    the port's separate ``run`` / ``run_occupancy`` on the same draws."""
    jspec, params, field = fields
    T, K, G = (32, 16, 8) if occupancy else (24, 24, 8)
    kw = dict(bound=1.0, min_near=0.02, min_near_lidar=0.02,
              lidar_max_depth=0.9, num_steps=T, active_sensor=True)
    jrend, trend = RendererSpec(field=jspec, **kw), Renderer(field=field,
                                                             **kw)
    (ro_l, rd_l), (ro_c, rd_c) = _rays(8, 12), _rays(9, 8)
    rng = np.random.default_rng(10)
    grids = [np.where(rng.uniform(size=(G, G, G)) > p, 10.0, 0.0)
             .astype(np.float32) for p in (0.5, 0.3)]
    key = jax.random.PRNGKey(11)
    k, kl, kc = jax.random.split(key, 3)
    _, kjl, kjc = jax.random.split(k, 3)
    u = lambda k_, shape: torch.from_numpy(np.array(  # noqa: E731
        jax.random.uniform(k_, shape)))
    draws = [{"z_noise": u(kz, (len(ro), T)), "jitter_u": u(kj, (len(ro), K))}
             for kz, kj, ro in ((kl, kjl, ro_l), (kc, kjc, ro_c))]
    t = np.float32(0.25)
    occ_j = dict(occ_spec=OccupancyGridSpec(grid_size=G),
                 occ_grid_l=jnp.asarray(grids[0]),
                 occ_grid_c=jnp.asarray(grids[1]), num_steps_occ=K,
                 occ_thresh=1.0) if occupancy else {}
    occ_t = dict(occ=OccupancyGrid(grid_size=G),
                 occ_grid_l=torch.from_numpy(grids[0]),
                 occ_grid_c=torch.from_numpy(grids[1]), num_steps_occ=K,
                 occ_thresh=1.0) if occupancy else {}
    cts = [rng.standard_normal(s).astype(np.float32)
           for s in ((12,), (12, 2), (8,), (8, 3))]
    keys = (("depth_lidar", "image_lidar"), ("depth", "image"))

    def loss(outs, xp):
        cs = [xp.asarray(c) for c in cts]
        return sum(xp.sum(o[k_] * c) for o, ks, cb in
                   zip(outs, keys, (cs[:2], cs[2:])) for k_, c in zip(ks, cb))

    def jf(p):
        o_l, o_c, _ = jrend.run_joint(
            p, *map(jnp.asarray, (ro_l, rd_l, ro_c, rd_c)), t, perturb=True,
            key=key, bg_color=1.0, **occ_j)
        return loss((o_l, o_c), jnp), (o_l, o_c)

    grad_fn = jax.value_and_grad(jf, has_aux=True)
    (_, jouts), jg = (jax.jit(grad_fn) if occupancy else grad_fn)(params)
    field.zero_grad(set_to_none=True)
    outs = trend.run_joint(*map(torch.from_numpy, (ro_l, rd_l, ro_c, rd_c)),
                           torch.tensor(t), perturb=True, draws_l=draws[0],
                           draws_c=draws[1], bg_color=1.0, **occ_t)
    for o, jo in zip(outs, jouts):
        # the jitted JAX render may contract the jitter's multiply-add,
        # which moves a depth by an ulp of the far plane (< 1)
        np.testing.assert_allclose(o["z_vals"].detach().numpy(),
                                   np.asarray(jo["z_vals"]), rtol=0,
                                   atol=2.0**-22)
        for k_ in o:
            np.testing.assert_allclose(o[k_].detach().numpy(),
                                       np.asarray(jo[k_]), err_msg=k_, **FWD)
    loss(outs[:2], torch).backward()
    flat = bridge.flatten_tree(jax.tree.map(np.asarray, jg))
    joint = _grads(field)
    _assert_grads_close(joint, {k: v for k, v in flat.items() if not (
        occupancy and k.startswith("flow."))}, 1e-4)

    field.zero_grad(set_to_none=True)
    seps = []
    for ro, rd, lidar, grid, dr in ((ro_l, rd_l, True, 0, draws[0]),
                                    (ro_c, rd_c, False, 1, draws[1])):
        args = (torch.from_numpy(ro), torch.from_numpy(rd), torch.tensor(t))
        if occupancy:
            seps.append(trend.run_occupancy(
                *args, occ_t["occ"], torch.from_numpy(grids[grid]),
                num_steps_occ=K, cal_lidar_color=lidar, perturb=True,
                occ_thresh=1.0, bg_color=1.0, **dr))
        else:
            seps.append(trend.run(*args, cal_lidar_color=lidar,
                                  perturb=True, z_noise=dr["z_noise"],
                                  bg_color=1.0))
    for o, sep in zip(outs, seps):
        for k_ in sep:
            np.testing.assert_allclose(o[k_].detach().numpy(),
                                       sep[k_].detach().numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k_)
    loss(seps, torch).backward()
    _assert_grads_close(joint, _grads(field), 1e-5)


# ----------------------------------------------------------------------
# the joint Trainer step
# ----------------------------------------------------------------------

def _joint_draws(jtr, state, fi):
    """The random draws of one JAX joint step: the sampler draws of the
    separate step, and ``run_joint``'s z-noise and jitter per branch."""
    cfg = jtr.cfg
    d = _jax_draws(jtr, state, fi, False)
    k_pl = jax.random.split(state["key"], 6)[3]
    k, kl, kc = jax.random.split(k_pl, 3)
    _, kjl, kjc = jax.random.split(k, 3)
    for branch, n, kz, kj in (("lidar", cfg.num_rays_lidar, kl, kjl),
                              ("rgb", cfg.num_rays, kc, kjc)):
        d[f"{branch}_render"] = {
            "z_noise": torch.from_numpy(np.asarray(
                jax.random.uniform(kz, (n, cfg.num_steps)))),
            "jitter_u": torch.from_numpy(np.asarray(
                jax.random.uniform(kj, (n, cfg.num_steps_occ))))}
    return d


def _record_kinks(field, monkeypatch):
    """Record the samples of each ``density_joint`` call whose sigma net
    has a hidden pre-activation within 1e-6 of zero: a ReLU kink that
    rounding can put on either side in the two frameworks. Fills ``rows``
    (those samples' positions, both branches) and ``t``."""
    kink = {}
    orig = field.density_joint

    def first_layer(mlp, args):
        with torch.no_grad():
            pre = args[0].to(torch.float32) @ mlp[0]
            kink["rows"] = kink["x"][(pre.abs() < 1e-6).any(-1)]

    def density_joint(x_l, x_c, t, **kw):
        kink["x"], kink["t"] = torch.cat([x_l, x_c]).detach(), t
        hook = field.sigma_net.register_forward_pre_hook(first_layer)
        try:
            return orig(x_l, x_c, t, **kw)
        finally:
            hook.remove()

    monkeypatch.setattr(field, "density_joint", density_joint)
    return kink


def _kink_footprint(field, kink):
    """The parameter entries the kink samples reach: where the gradient of
    their summed density outputs is not zero (LiDAR rows through the
    LiDAR encoders, camera rows through the camera's; both branches' are
    taken for every row, a superset)."""
    field.zero_grad(set_to_none=True)
    for lidar in (True, False):
        out = field.density(kink["rows"], kink["t"], cal_lidar_color=lidar)
        (out["sigma"].sum() + out["geo_feat"].sum()).backward()
    return {k: v.numpy() != 0 for k, v in _grads(field).items()}


def test_joint_step_matches_jax_and_separate(tmp_path, monkeypatch):
    """One random step of the joint trainer (occupancy mode, flow and URF
    losses, the flow loss's cloud in the joint flow batch) against the
    JAX joint step from the same bridged state and draws; then the port's
    separate step on the same draws gives the same loss and gradients
    within 1e-5 of each gradient's largest value."""
    from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
    from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
    from nvsf_tpu.train.trainer import Trainer as JaxTrainer
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer
    _shared_rays(monkeypatch)
    cfg = _config(joint_fusion=True)
    jtr = JaxTrainer(cfg, jax_scene(JaxSceneSpec(**SPEC), split="train"),
                     workspace=str(tmp_path))
    tr = Trainer(cfg, make_synthetic_scene(SyntheticSceneSpec(**SPEC),
                                           split="train"), device="cpu")
    assert tr.joint
    state = dict(jtr.state)
    G = cfg.occ_grid_size
    grid = np.full((G, G, G), 32.0, np.float32)
    grid[:, :, :G // 2 - 3] = 0.0
    state["occ_grid_lidar"] = state["occ_grid_rgb"] = jnp.asarray(grid)
    bridge.load_trainer_state(tr, jax.tree.map(np.asarray, state))
    fi = 1
    draws = _joint_draws(jtr, state, fi)
    new_state, metrics = _jax_step(jtr, state, fi, False)
    jgrads = bridge.flatten_tree(jax.tree.map(np.asarray,
                                              new_state["opt_state"]))
    tr.field.zero_grad(set_to_none=True)
    kink = _record_kinks(tr.field, monkeypatch)
    loss, parts, _ = tr.loss_and_grads(fi, False, draws)
    np.testing.assert_allclose(float(loss), float(metrics["loss"]),
                               rtol=1e-4)
    assert set(parts) == {"loss_d", "loss_i", "loss_rd", "chamfer", "flow",
                          "urf", "rgb"}
    for k, v in parts.items():
        np.testing.assert_allclose(float(v), float(metrics[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    joint = _grads(tr.field)
    touched = _kink_footprint(tr.field, kink)
    assert kink["rows"].numel() > 0
    for k, r in jgrads.items():
        scale = max(float(np.abs(r).max()), 1e-12)
        off = np.abs(joint[k].numpy() - r) > 1e-4 * scale
        # what departs lies in the footprint of the kink samples
        assert not (off & ~touched[k]).any(), (k, int(off.sum()))
        np.testing.assert_allclose(joint[k].numpy(), r, rtol=0,
                                   atol=2e-3 * scale, err_msg=k)

    tr.joint = False
    tr.field.zero_grad(set_to_none=True)
    loss_sep, _, _ = tr.loss_and_grads(fi, False, draws)
    np.testing.assert_allclose(float(loss), float(loss_sep), rtol=1e-6)
    _assert_grads_close(joint, _grads(tr.field), 1e-5)


def test_joint_fusion_guards():
    """The trainer refuses what the fused path cannot honor, with the JAX
    package's messages: a camera sample budget other than the LiDAR's,
    and remat chunks."""
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer
    scene = make_synthetic_scene(SyntheticSceneSpec(**SPEC), split="train")
    with pytest.raises(ValueError, match="num_steps_occ_rgb=32 != "
                                         "num_steps_occ=16"):
        Trainer(_config(joint_fusion=True, num_steps_occ=16,
                        num_steps_occ_rgb=32), scene, device="cpu")
    with pytest.raises(ValueError, match="remat_chunks"):
        Trainer(_config(joint_fusion=True, render_mode="uniform",
                        remat_chunks=4), scene, device="cpu")
    Trainer(_config(joint_fusion=True, num_steps_occ_rgb=32,
                    num_steps_occ=32), scene, device="cpu")
