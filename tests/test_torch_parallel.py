"""Ray-sharded data parallelism (``nvsf_torch/parallel/mesh.py``) on two
CPU ranks over gloo: the mesh helpers; the port's 2-rank step against the
JAX package's sharded step on ``make_mesh(2)`` (draws replayed with
``test_torch_step._jax_draws``) and against the port's own single process,
in the occupancy, dense uniform (``remat_chunks`` 2) and ``joint_fusion``
modes; the replicated state after an epoch spanning an occupancy refresh;
and the sharded ``render_lidar_sweep`` against the JAX package's sharded
sweep.

Every 2-rank case runs in one spawn of two ranks (``torch_mesh_ranks``,
which imports no jax), each rank on one torch thread, meeting through a
``file://`` store in a fresh temporary directory, with a time limit on the
rendezvous, every collective and the whole spawn.

Tolerances:
- against JAX, those of ``test_torch_step.py``: losses rtol 1e-4,
  gradients 1e-4 of each parameter's largest JAX gradient. After Adam's
  first step a parameter moves by lr * g / (|g| + 1e-15), so by its
  group's rate times the sign of its gradient: where the JAX gradient
  exceeds the gradient tolerance the signs agree and the parameters must
  agree to 1e-4 of the move; elsewhere a sign may differ, by two moves.
- 2 ranks against 1 rank: gradients within 1e-5 of each tensor's largest
  magnitude (phase 10's bound in ``chip_smoke.py``: the same per-ray
  functions, summed over two ranks in another order), losses rtol 1e-5.
  Half the gather's gradient scale moves the ray terms' share of every
  gradient by half, far beyond it. No ReLU gate needs pinning here (as
  ``test_torch_joint.py`` pins the JAX comparison's): both sides run the
  same CPU kernels (their losses came out bit-equal), and the worst
  gradient measured 2.1-3.2e-6 of its tensor's max.
- the sharded sweep: the renders' JAX tolerance (rtol 1e-4, atol 1e-5)
  plus 1e-4 of the largest value: each rank's marcher sorts and chunks its
  own rays, and a ray's output then differs by what its chunk adds after
  the ray's transmittance fell below 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nvsf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from nvsf_tpu.render.sweep import render_lidar_sweep as jax_lidar_sweep
from nvsf_tpu.train.trainer import Trainer as JaxTrainer
from nvsf_tpu.train.trainer import field_spec_from_config
from nvsf_tpu.train.trainer import make_optimizer as jax_make_optimizer
from nvsf_torch import bridge
from nvsf_torch.parallel.mesh import Mesh, mesh_from_spec, shard_rays, spawn
from nvsf_torch.scripts.main_nvsf import mesh_size

import torch_mesh_ranks as R
from test_torch_models import one_torch_thread  # noqa: F401
from test_torch_step import SPEC, _config, _jax_draws, _jax_step, _shared_rays
from test_trainer import SCENE_SPEC, tiny_config

FI = 1
# the step cases and the port's configs: (name, config, patch step)
STEPS = {
    "occupancy patch": (dict(grad_loss=True), True),
    "uniform remat": (dict(render_mode="uniform", remat_chunks=2), False),
    "joint_fusion": (dict(joint_fusion=True), False),
}
SWEEP = dict(num_steps_occ=24, max_ray_batch=256, occ_grid_size=16)


def _cfg(**over):
    return _config(**over).to_dict()


def _portable(state):
    """The arrays of a JAX trainer state that a port trainer loads, as
    numpy: no optax state classes, which would import jax into a rank."""
    return {k: jax.tree.map(np.asarray, state[k]) for k in (
        "params", "ema_params", "error_map", "error_map_rgb",
        "occ_grid_lidar", "occ_grid_rgb", "unet_params", "unet_stats")
        if k in state}


def _jax_state(jtr, seed):
    """The JAX trainer's state as numpy, the parameters perturbed and an
    occupancy grid with an empty half-space (test_torch_eval.py)."""
    rng = np.random.default_rng(seed)
    state = _portable(jtr.state)
    for k in ("params", "ema_params"):
        state[k] = jax.tree.map(
            lambda a: (a + rng.standard_normal(a.shape) * 0.1
                       * max(float(np.abs(a).max()), 1e-3))
            .astype(np.float32), state[k])
    if "occ_grid_lidar" in state:
        G = jtr.cfg.occ_grid_size
        grid = np.full((G, G, G), 32.0, np.float32)
        grid[:, :, :G // 2 - 3] = 0.0
        state["occ_grid_lidar"] = state["occ_grid_rgb"] = grid
    return state


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's sharded step and sweep on ``make_mesh(2)``, and
    the inputs the port's ranks replay."""
    mesh = jax_make_mesh(2)
    with pytest.MonkeyPatch.context() as mp:
        _shared_rays(mp)
        # the step: tests/test_trainer.py's tiny config (LiDAR only, the
        # dense uniform default)
        cfg = tiny_config()
        jtr = JaxTrainer(cfg, jax_scene(SCENE_SPEC, split="train"),
                         workspace=str(tmp_path_factory.mktemp("jstep")),
                         mesh=mesh)
        state = dict(jtr.state)
        # the tiny config has no camera; its draws are dropped
        draws = _jax_draws(jtr, dict(state, error_map_rgb=state["error_map"]),
                           FI, False)
        draws = {k: v for k, v in draws.items() if k.startswith("lidar")}
        new, metrics = _jax_step(jtr, state, FI, False)
        tx = jax_make_optimizer(cfg, field_spec_from_config(cfg),
                                state["params"])
        upd, _ = tx.update(new["opt_state"], tx.init(state["params"]),
                           state["params"])
        step = {"cfg": cfg.to_dict(), "draws": draws,
                "state": _portable(state),
                "loss": float(metrics["loss"]),
                "parts": {k: float(v) for k, v in metrics.items()},
                "grads": bridge.flatten_tree(
                    jax.tree.map(np.asarray, new["opt_state"])),
                "before": bridge.flatten_tree(
                    jax.tree.map(np.asarray, state["params"])),
                "params": bridge.flatten_tree(jax.tree.map(
                    np.asarray, optax.apply_updates(state["params"],
                                                    upd)))}
        # the sweep: two LiDAR frames through the occupancy marcher
        scfg = _config(**SWEEP)
        jtr = JaxTrainer(scfg, jax_scene(JaxSceneSpec(**SPEC),
                                         split="train"),
                         workspace=str(tmp_path_factory.mktemp("jsweep")))
        sstate = _jax_state(jtr, 2)
        jtr.state.update(jax.tree.map(jnp.asarray, sstate))
        sc = jtr.scene
        fis = [0, 2]
        sweep = jax_lidar_sweep(
            jtr.rend, jtr.state["params"], np.asarray(sc.poses_lidar)[fis],
            np.asarray(sc.times)[fis], sc.H_lidar, sc.W_lidar,
            sc.intrinsics_lidar, sc.intrinsics_hoz_lidar, mesh=mesh,
            occ_kwargs=jtr._occ_kwargs(jtr.state["occ_grid_lidar"],
                                       lidar=True))
    return {"step": step, "sweep": {"cfg": scfg.to_dict(), "state": sstate,
                                    "fis": fis, "out": sweep}}


@pytest.fixture(scope="module")
def two_ranks(jax_side):
    """Every 2-rank case, in one spawn of two CPU ranks (rank order)."""
    js, sw = jax_side["step"], jax_side["sweep"]
    spec = dataclasses.asdict(SCENE_SPEC)
    todo = [("gather", "gather", (7,)),
            ("jax step", "step", (js["cfg"], spec, FI, False, js["state"],
                                  js["draws"], True)),
            ("epoch", "epoch", (_cfg(occ_update_interval=2), SPEC,
                                [0, 1, 2])),
            ("sweep", "sweep", (sw["cfg"], SPEC, sw["state"], sw["fis"]))]
    todo += [(name, "step", (_cfg(**over), SPEC, FI, patch))
             for name, (over, patch) in STEPS.items()]
    return spawn(R.cases, 2, (todo,), device="cpu", timeout=300.0)


def test_mesh_helpers():
    """``mesh_from_spec`` folds the axes; an empty ``mesh_shape`` takes
    every card when there are several, and none (one process) otherwise;
    ``shard_rays`` covers an uneven split exactly once, in order, as XLA
    splits a sharded dimension."""
    assert mesh_from_spec("4x2") == 8 and mesh_from_spec("8") == 8
    with pytest.raises(ValueError, match="axis"):
        mesh_from_spec("2x0")
    assert mesh_size("", 3) == 3 and mesh_size("", 1) == 0
    assert mesh_size("", None) == 0 and mesh_size("4x2", None) == 8
    x = torch.arange(7)
    for world, sizes in ((2, [4, 3]), (3, [3, 3, 1]), (8, [1] * 7 + [0])):
        parts = [shard_rays(Mesh(world, r, torch.device("cpu")), x)[0]
                 for r in range(world)]
        assert [len(p) for p in parts] == sizes
        assert torch.equal(torch.cat(parts), x)
    with pytest.raises(ValueError, match="ray counts"):
        shard_rays(Mesh(2, 0, torch.device("cpu")), x, x[:3])


def test_gather_rays_forward_and_backward(two_ranks):
    """Every rank gets the whole 3x ramp; the backward sums the gradient
    over the ranks, so each slice gets twice its share (rows i, 3 * i,
    from both ranks' identical losses). The ranks ran without jax."""
    x = np.arange(14, dtype=np.float32).reshape(7, 2)
    rows = np.arange(7, dtype=np.float32)[:, None]
    for r, res in enumerate(two_ranks):
        assert not res["jax imported"]
        g = res["gather"]
        np.testing.assert_array_equal(g["y"], 3 * x)
        lo, hi = g["bounds"]
        assert (lo, hi) == ((0, 4), (4, 7))[r]
        np.testing.assert_array_equal(g["grad"],
                                      np.broadcast_to(2 * 3 * rows[lo:hi],
                                                      (hi - lo, 2)))


def test_two_rank_step_matches_jax_sharded_step(jax_side, two_ranks):
    """tests/test_trainer.py's tiny config, one random step on the JAX
    package's draws: the loss, the parts and the gradients before Adam of
    each rank against the JAX step on ``make_mesh(2)``, and the parameters
    after Adam (see the module's tolerances)."""
    ref = jax_side["step"]
    for res in two_ranks:
        got = res["jax step"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        for k, v in got["parts"].items():
            np.testing.assert_allclose(v, ref["parts"][k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
        for k, g in got["grads"].items():
            rg = ref["grads"][k]
            tol = 1e-4 * max(float(np.abs(rg).max()), 1e-12)
            np.testing.assert_allclose(g, rg, rtol=0, atol=tol, err_msg=k)
            moved = np.abs(ref["params"][k] - ref["before"][k]).max()
            allowed = np.where(np.abs(rg) > tol, 1e-4, 2.0) * moved + 1e-12
            np.testing.assert_array_less(
                np.abs(got["params"][k] - ref["params"][k]), allowed,
                err_msg=k)
    for k, v in two_ranks[0]["jax step"]["params"].items():
        np.testing.assert_array_equal(two_ranks[1]["jax step"]["params"][k],
                                      v, err_msg=k)


@pytest.mark.parametrize("case", list(STEPS))
def test_two_rank_step_matches_one_rank(two_ranks, case):
    """One step on two ranks and in one process, from the same seed with
    no injected draws: every draw is made at the batch's full shape, so
    the losses agree (rtol 1e-5), and the gradients before Adam agree
    within 1e-5 of each tensor's largest magnitude, on both ranks. The
    occupancy patch step carries every loss (chamfer, flow, URF, the patch
    regularizer, camera RGB); the uniform one recomputes its density in two
    remat chunks; the joint one renders both branches in one pass."""
    over, patch = STEPS[case]
    ref = R.step(None, _cfg(**over), SPEC, FI, patch)
    for res in two_ranks:
        got = res[case]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        assert set(got["parts"]) == set(ref["parts"])
        for k, v in got["parts"].items():
            np.testing.assert_allclose(v, ref["parts"][k], rtol=1e-5,
                                       atol=1e-8, err_msg=k)
        for k, g in got["grads"].items():
            rg = ref["grads"][k]
            np.testing.assert_allclose(
                g, rg, rtol=0, atol=1e-5 * max(float(np.abs(rg).max()),
                                               1e-30), err_msg=k)


def test_replicated_state_is_bitwise_equal_across_ranks(two_ranks):
    """Three steps and the epoch's EMA, with an occupancy refresh after the
    second step: parameters, EMA, Adam moments, error maps and grids hold
    the same bits on both ranks; the epoch's loss is the single
    process's."""
    ref = R.epoch(None, _cfg(occ_update_interval=2), SPEC, [0, 1, 2])
    for res in two_ranks:
        got = res["epoch"]
        assert got["differ"] == []
        assert got["checked"] == ["adam", "ema", "error_map", "error_map_rgb",
                                  "field", "occ_grid_lidar", "occ_grid_rgb",
                                  "unet"]
        assert got["refreshes"] == ref["refreshes"] == 1
        assert got["steps"] == 3
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-4)
        kinds = got["collectives"]
        assert kinds["all_reduce grads"]["calls"] >= 3
        assert kinds["broadcast occupancy grid"]["calls"] == 2
        # a row of each of the two error maps a step
        assert kinds["broadcast error map"]["calls"] == 6


def test_sharded_sweep_matches_jax_sharded_sweep(jax_side, two_ranks):
    """Two LiDAR frames through the occupancy marcher, sharded over two
    ranks, against the JAX package's sweep on ``make_mesh(2)`` (see the
    module's tolerances); both ranks hold the whole frames."""
    ref = jax_side["sweep"]["out"]
    for res in two_ranks:
        got = res["sweep"]
        for k in ("depth", "raydrop", "intensity"):
            r = np.asarray(ref[k])
            np.testing.assert_allclose(
                got[k], r, rtol=1e-4,
                atol=1e-5 + 1e-4 * float(np.abs(r).max()), err_msg=k)
    for k, v in two_ranks[0]["sweep"].items():
        np.testing.assert_array_equal(two_ranks[1]["sweep"][k], v)
