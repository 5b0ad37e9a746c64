"""Rank programs of ``tests/test_torch_parallel.py``: each runs on one rank
of a CPU mesh (``nvsf_torch.parallel.mesh.spawn``, gloo) or, with
``mesh=None``, in the test's own process as the one-process reference.
This module imports no jax, so that the spawned ranks start on torch and
the port alone; the numpy ray functions that the JAX parity tests share
between the two packages (``test_torch_step._shared_rays``) live here for
the same reason.
"""

import contextlib
import sys

import numpy as np
import torch

from nvsf_torch import bridge
from nvsf_torch.config import NVSFConfig
from nvsf_torch.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_torch.parallel.mesh import (gather_rays, replicas_differ,
                                      shard_rays)


# ----------------------------------------------------------------------
# rays from numpy, for both packages
# ----------------------------------------------------------------------

def np_lidar_rays(pose, inds, H, W, K, K_hoz):
    fov_up, fov = K
    j = (inds // W).astype(np.float32)
    i = (inds % W).astype(np.float32)
    beta = -(i - W / 2) / W * np.float32(K_hoz[1]) / 180 * np.float32(np.pi)
    alpha = (np.float32(fov_up) - j / H * np.float32(fov)) / 180 \
        * np.float32(np.pi)
    d = np.stack([np.cos(alpha) * np.cos(beta), np.cos(alpha) * np.sin(beta),
                  np.sin(alpha)], -1).astype(np.float32)
    return np_pose_rays(pose, d)


def np_camera_rays(pose, inds, H, W, K):
    j = (inds // W).astype(np.float32) + 0.5
    i = (inds % W).astype(np.float32) + 0.5
    d = np.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                  np.ones_like(i)], -1).astype(np.float32)
    return np_pose_rays(pose, d / np.linalg.norm(d, axis=-1, keepdims=True))


def np_pose_rays(pose, d):
    pose = np.asarray(pose, np.float32)
    rd = (d @ pose[:3, :3].T).astype(np.float32)
    return np.broadcast_to(pose[:3, 3], rd.shape).copy(), rd


def _torch_side(np_fn):
    def call(pose, inds, *args):
        args = [a.numpy() if torch.is_tensor(a) else a for a in args]
        ro, rd = np_fn(pose.numpy(), inds.numpy(), *args)
        return torch.from_numpy(ro), torch.from_numpy(rd)
    return call


torch_lidar_rays = _torch_side(np_lidar_rays)
torch_camera_rays = _torch_side(np_camera_rays)


@contextlib.contextmanager
def numpy_rays(on=True):
    """The port's ray functions are the numpy ones inside the block."""
    from nvsf_torch.lib import rays
    saved = rays.get_lidar_rays, rays.get_camera_rays
    if on:
        rays.get_lidar_rays = torch_lidar_rays
        rays.get_camera_rays = torch_camera_rays
    try:
        yield
    finally:
        rays.get_lidar_rays, rays.get_camera_rays = saved


# ----------------------------------------------------------------------
# rank programs
# ----------------------------------------------------------------------

def _trainer(mesh, cfg, spec, state=None):
    from nvsf_torch.train.trainer import Trainer
    tr = Trainer(NVSFConfig.from_dict(cfg),
                 make_synthetic_scene(SyntheticSceneSpec(**spec),
                                      split="train"),
                 device="cpu", mesh=mesh)
    if state is not None:
        bridge.load_trainer_state(tr, state)
    return tr


def _np(named):
    return {k: v.detach().numpy().copy() for k, v in named}


def gather(mesh, n):
    """``gather_rays`` of 3 x this rank's slice of an [n, 2] ramp, and the
    gradient that the loss sum(y * row index) hands the slice."""
    x = torch.arange(n * 2, dtype=torch.float32).reshape(n, 2)
    xs = shard_rays(mesh, x)[0].clone().requires_grad_(True)
    y = gather_rays(mesh, xs * 3, n)
    (y * torch.arange(n)[:, None]).sum().backward()
    return {"y": y.detach().numpy(), "grad": xs.grad.numpy(),
            "bounds": mesh.bounds(n)}


def step(mesh, cfg, spec, fi, patch, state=None, draws=None,
         np_rays=False):
    """One step on frame ``fi``: its loss and parts, the gradients it
    leaves before Adam (averaged over the ranks under a mesh), and the
    parameters after Adam."""
    from nvsf_torch.train.trainer import zero_nan_grads
    tr = _trainer(mesh, cfg, spec, state)
    params = list(tr.field.parameters())
    tr.optimizer.zero_grad(set_to_none=False)
    with numpy_rays(np_rays):
        loss, parts, _ = tr.loss_and_grads(fi, patch, draws)
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
             .numpy().copy() for k, p in tr.field.named_parameters()}
    zero_nan_grads(params)
    tr.optimizer.step()
    return {"loss": float(loss), "parts": {k: float(v)
                                           for k, v in parts.items()},
            "grads": grads, "params": _np(tr.field.named_parameters())}


def epoch(mesh, cfg, spec, order):
    """One epoch over ``order``: its loss, the occupancy refreshes, and
    under a mesh the replicated state that differs from rank 0's and the
    collectives issued."""
    tr = _trainer(mesh, cfg, spec)
    tr.epoch = 1
    st = tr.train_one_epoch(order=order)
    out = {"loss": st.loss, "refreshes": tr.occ_refresh_count,
           "steps": tr.global_step}
    if mesh is not None:
        state = tr.replicated_state()
        out["differ"] = replicas_differ(mesh, state)
        out["checked"] = sorted({k.split(".")[0] for k in state})
        out["collectives"] = mesh.collectives
    return out


def scan_refreshes(mesh, cfg, spec, steps, epochs):
    """``epochs`` scanned epochs (``use_scan=True``) of frames
    0..steps-1 -> the global steps at which the grids refreshed."""
    tr = _trainer(mesh, cfg, spec)
    seen = []
    refresh = tr.refresh_occupancy

    def record(seed):
        seen.append(tr.global_step)
        refresh(seed)

    tr.refresh_occupancy = record
    for ep in range(1, epochs + 1):
        tr.epoch = ep
        tr.train_one_epoch(order=np.arange(steps), use_scan=True)
    return seen


def sweep(mesh, cfg, spec, state, fis):
    """LiDAR frames ``fis`` through ``render_lidar_sweep`` (the occupancy
    marcher) on rays from numpy."""
    from nvsf_torch.render.sweep import render_lidar_sweep
    tr = _trainer(mesh, cfg, spec, state)
    sc = tr.scene
    with numpy_rays():
        return render_lidar_sweep(
            tr.renderer, sc.poses_lidar[fis], sc.times[fis], sc.H_lidar,
            sc.W_lidar, sc.intrinsics_lidar, sc.intrinsics_hoz_lidar,
            occ_kwargs=tr._occ_kwargs(tr.occ_grid_lidar, lidar=True),
            mesh=mesh)


def cases(mesh, todo):
    """Each (name, program, args) of ``todo`` in turn -> {name: result},
    and whether jax was imported into the rank."""
    out = {name: globals()[prog](mesh, *args) for name, prog, args in todo}
    out["jax imported"] = "jax" in sys.modules
    return out
