"""The scanned epoch (``Trainer.train_one_epoch(use_scan=True)``, the
default) against the JAX package's, on the CPU.

- The global steps at which the occupancy grids refresh: the JAX package
  cuts a scanned epoch into dispatches of ``occ_update_interval`` steps
  counted from the epoch's start and refreshes only between them
  (``nvsf_tpu/train/trainer.py:694-736``); its step path refreshes after
  any step that crosses a multiple of the interval. The JAX side runs its
  host loop with its compiled scan and step replaced on the instance by
  stubs that advance nothing (the chunking lives in the host loop), its
  refreshes recorded by wrapping its ``_occ_update``; the port's side runs
  real toy steps.
- A step given its frame as a device scalar equals the step given an int,
  bit for bit, on the same injected draws.
- The EMA moves once an epoch, by JAX's formula (``trainer.py:262-265``),
  and the epoch's parts are the means of its steps' metrics.
- Two ranks of a CPU mesh (gloo) refresh at the same boundaries.
"""

import numpy as np
import pytest
import torch

from nvsf_tpu.config import NVSFConfig as JaxConfig
from nvsf_tpu.data.synthetic import SyntheticSceneSpec as JaxSceneSpec
from nvsf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from nvsf_tpu.train.trainer import Trainer as JaxTrainer
from nvsf_torch.config import NVSFConfig
from nvsf_torch.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_torch.train.trainer import Trainer

from test_torch_models import one_torch_thread  # noqa: F401

SPEC = dict(H_lidar=16, W_lidar=32, H=16, W=24, max_depth=80.0,
            scale=1.0 / 81.0)
FRAMES = 7      # 6 training frames (the middle one is the val frame)


def _config(interval, **over):
    """A toy occupancy-mode config (patch epochs every 2nd epoch)."""
    s = SPEC["scale"]
    d = dict(enable_lidar=True, enable_rgb=True, num_frames=FRAMES,
             scale=s, bound=1.0, min_near_lidar=s, lidar_max_depth=80 * s,
             min_near=s, active_sensor=True, num_rays=32, num_rays_lidar=32,
             num_steps=16, num_steps_occ=8, render_mode="occupancy",
             log2_hashmap_size=10, n_levels_hash=2,
             n_features_per_level_hash=4, flow_n_levels=2,
             flow_log2_hashmap_size=10, max_resolution=64,
             flow_max_resolution=64, iters=100, use_error_map=True,
             occ_grid_size=8, occ_update_interval=interval,
             change_patch_size_lidar=[2, 4], change_patch_size_epoch=2)
    d.update(over)
    return d


def _port(interval, **over):
    cfg = NVSFConfig.from_dict(_config(interval, **over))
    scene = make_synthetic_scene(SyntheticSceneSpec(num_frames=FRAMES,
                                                    **SPEC))
    return Trainer(cfg, scene, device="cpu")


def _jax_refreshes(steps, interval, epochs, use_scan, tmp_path):
    """The JAX trainer's refresh steps over ``epochs`` epochs of
    ``steps`` frames, its compiled scan and step stubbed out."""
    cfg = JaxConfig.from_dict(_config(interval))
    jtr = JaxTrainer(cfg, jax_scene(JaxSceneSpec(num_frames=FRAMES, **SPEC),
                                    split="train"),
                     workspace=str(tmp_path))
    seen = []

    def occ_update(params, grid, key, ts, lidar):
        if lidar:
            seen.append(jtr.global_step)
        return grid

    def scan(state, order):
        return state, {"loss": np.zeros(len(order), np.float32)}

    jtr._occ_update = occ_update
    jtr._scan_random = jtr._scan_patch = scan
    jtr._step_random = jtr._step_patch = \
        lambda state, fi: (state, {"loss": np.float32(0)})
    for ep in range(1, epochs + 1):
        jtr.epoch = ep
        jtr.train_one_epoch(order=np.arange(steps), use_scan=use_scan)
    assert jtr._occ_refresh_count == len(seen)
    return seen


def _port_refreshes(steps, interval, epochs, use_scan):
    tr = _port(interval)
    seen = []
    refresh = tr.refresh_occupancy

    def record(seed):
        seen.append(tr.global_step)
        refresh(seed)

    tr.refresh_occupancy = record
    for ep in range(1, epochs + 1):
        tr.epoch = ep
        st = tr.train_one_epoch(order=np.arange(steps), use_scan=use_scan)
        assert np.isfinite(st.loss)
    assert tr.occ_refresh_count == len(seen)
    return seen


# steps an epoch, interval, epochs, use_scan -> the refresh steps
REFRESH_CASES = {
    # two dispatches an epoch (4 + 2 steps): after each, never mid-dispatch
    "scan-6-frames-interval-4": ((6, 4, 2, True), [4, 10, 12]),
    # an epoch no longer than the interval is one dispatch, refreshed after
    # it (and its EMA) once the tick has moved
    "scan-3-frames-interval-4": ((3, 4, 2, True), [6]),
    # the step path: after the step that crosses each multiple
    "step-6-frames-interval-4": ((6, 4, 2, False), [4, 8, 12]),
}


@pytest.mark.parametrize("case", list(REFRESH_CASES))
def test_refresh_steps_match_jax(case, tmp_path):
    args, expected = REFRESH_CASES[case]
    assert _jax_refreshes(*args, tmp_path) == expected
    assert _port_refreshes(*args) == expected


def test_two_rank_scanned_epochs_refresh_at_jax_boundaries(tmp_path):
    """Two gloo ranks of a CPU mesh run the scanned epoch eagerly, cut at
    the JAX package's dispatch boundaries: 2 epochs of 3 steps at interval
    2 refresh at global steps 2, 5 and 6 on both ranks, as JAX's scan does
    (its step path: 2, 4 and 6)."""
    import torch_mesh_ranks as R
    from nvsf_torch.parallel.mesh import spawn
    expected = _jax_refreshes(3, 2, 2, True, tmp_path)
    assert expected == [2, 5, 6]
    spec = dict(num_frames=FRAMES, **SPEC)
    ranks = spawn(R.scan_refreshes, 2, (_config(2), spec, 3, 2),
                  device="cpu", timeout=120.0)
    assert ranks == [expected, expected]


def _draws(tr, patch, seed):
    """Random draws of one step (numpy, from ``seed``) for ``draws``."""
    rng = np.random.default_rng(seed)
    cfg, scene = tr.cfg, tr.scene
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    out = {f"{b}_render": {"z_noise": t(rng.random((n, cfg.num_steps))),
                           "jitter_u": t(rng.random((n, cfg.num_steps_occ)))}
           for b, n in (("lidar", cfg.num_rays_lidar), ("rgb", cfg.num_rays))}
    if patch:
        ph, pw = cfg.change_patch_size_lidar
        npatch = cfg.num_rays_lidar // (ph * pw)
        He, We = tr.error_map.shape[1:]
        out["lidar_rays"] = {"gumbel": t(rng.gumbel(size=He * We)),
                             "ux": t(rng.random(npatch)),
                             "uy": t(rng.random(npatch))}
        He, We = tr.error_map_rgb.shape[1:]
        out["rgb_rays"] = {"ux": t(rng.random(cfg.num_rays)),
                           "uy": t(rng.random(cfg.num_rays))}
        if cfg.num_rays > He * We:     # drawn with replacement
            out["rgb_rays"]["coarse"] = torch.as_tensor(
                rng.integers(0, He * We, cfg.num_rays))
        else:
            out["rgb_rays"]["gumbel"] = t(rng.gumbel(size=He * We))
    else:
        out["lidar_rays"] = {"inds": torch.as_tensor(rng.integers(
            0, scene.H_lidar * scene.W_lidar, cfg.num_rays_lidar))}
        out["rgb_rays"] = {"inds": torch.as_tensor(rng.integers(
            0, scene.H * scene.W, cfg.num_rays))}
    return out


@pytest.mark.parametrize("patch", [False, True], ids=["random", "patch"])
def test_step_with_a_device_frame_index_equals_the_int_step(patch):
    """Two trainers from one seed take two steps on the same draws, one
    given frames as ints, one as int64 scalars: losses, parts, gradients,
    parameters, Adam moments and error maps equal bit for bit."""
    a, b = (_port(4, flow_loss=True, use_urf_loss=True, grad_loss=True)
            for _ in range(2))
    for seed, fi in enumerate((2, 1)):
        ma = a.train_step(fi, patch, _draws(a, patch, seed))
        mb = b.train_step(torch.tensor(fi), patch, _draws(b, patch, seed))
        assert ma.keys() == mb.keys() and "urf" in ma and "flow" in ma
        for k in ma:
            assert torch.equal(ma[k], mb[k]), k
    for (k, p), q in zip(a.field.named_parameters(), b.field.parameters()):
        assert torch.equal(p, q) and torch.equal(p.grad, q.grad), k
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(a.optimizer.state[p][m],
                               b.optimizer.state[q][m]), (k, m)
    assert torch.equal(a.error_map, b.error_map)
    assert torch.equal(a.error_map_rgb, b.error_map_rgb)
    assert a.global_step == b.global_step == int(b._step_t) == 2


def test_ema_once_an_epoch_and_parts_are_step_means():
    """Over a scanned epoch of two dispatches the EMA stays put at every
    step and then moves once, to JAX's decay * ema + (1 - decay) *
    params; the epoch's loss and parts are the means of its steps'."""
    tr = _port(4, ema_decay=0.9)
    tr.epoch = 1
    ema0 = {k: v.clone() for k, v in tr.ema.items()}
    steps = []
    step = tr.train_step

    def record(fi, patch, draws=None):
        for k, v in tr.ema.items():
            assert torch.equal(v, ema0[k]), f"EMA moved inside the epoch: {k}"
        m = step(fi, patch, draws)
        steps.append({k: float(v) for k, v in m.items()})
        return m

    tr.train_step = record
    st = tr.train_one_epoch(order=[5, 0, 3, 1, 4, 2])
    assert len(steps) == 6 and tr.occ_refresh_count == 1
    for k, p in tr.field.named_parameters():
        ref = 0.9 * ema0[k].numpy() + np.float32(1 - 0.9) * p.detach().numpy()
        np.testing.assert_allclose(tr.ema[k].numpy(), ref, rtol=1e-6,
                                   atol=1e-9, err_msg=k)
    assert set(st.parts) == set(steps[0])
    for k, v in st.parts.items():
        np.testing.assert_allclose(v, np.mean([s[k] for s in steps]),
                                   rtol=1e-5, err_msg=k)
    assert st.loss == st.parts["loss"]
