"""Full-frame LiDAR and camera renders for a list of poses (counterpart of
``nvsf_tpu/render/sweep.py``), on the renderer's device, one frame after
another. Each frame is rendered as ``Renderer.render`` renders its rays:
the occupancy-sorted early-exit marcher with an occupancy grid, chunks of
the dense uniform ``run`` without one. On the card a frame replays the
renderer's frame graphs (``render/frame_graph.py``; the JAX package jits
its sweeps per shape), its rays made inside them from the pose; each frame
comes back as fresh tensors, so that ``_stack`` may keep them.

With a ``mesh`` (``nvsf_torch.parallel.mesh``) a frame's rays are padded
to a multiple of the rank count (origin 0, direction 1, as
``nvsf_tpu/render/sweep.py:27-34`` pads them), each rank renders its
slice, and the whole frame is gathered onto every rank. The marcher sorts
and chunks the rays of each rank's slice, where the JAX package's sharded
program sorts the whole frame's: a ray's output differs by what its chunk
adds after the ray's transmittance fell below the marcher's 1e-4, so by
at most 1e-4 of the largest depth or color.
"""

from __future__ import annotations

import numpy as np
import torch

from nvsf_torch.lib import rays as raylib
from nvsf_torch.parallel.mesh import gather_rays, shard_rays


def _device(rend) -> torch.device:
    return next(rend.field.parameters()).device


def _render_frame(rend, rays, rays_key, n_rays, inputs, t, mesh,
                  **kw) -> dict:
    """The whole frame's outputs of the ``n_rays`` rays that
    ``rays(**inputs)`` makes on the renderer's device from the host arrays
    ``inputs``, at time ``t``. On the card without a mesh, a replay of the
    renderer's frame graphs, the rays made inside them
    (``FrameGraphs.render_frame``); else ``rend.render`` of the rays,
    sharded over ``mesh`` when one is given (each rank's slice through its
    own graphs on the card, the gather outside them)."""
    dev = _device(rend)
    if mesh is None and dev.type == "cuda":
        return rend.frame_graphs.render_frame(rays, rays_key, n_rays, inputs,
                                              float(t), **kw)
    ro, rd = rays(**{k: torch.as_tensor(np.asarray(v), dtype=torch.float32,
                                        device=dev)
                     for k, v in inputs.items()})
    t = torch.tensor(float(t), device=dev)
    if mesh is None:
        return rend.render(ro, rd, t, **kw)
    pad = (-n_rays) % mesh.world_size
    ro = torch.cat([ro, ro.new_zeros((pad, 3))])
    rd = torch.cat([rd, rd.new_ones((pad, 3))])
    out = rend.render(*shard_rays(mesh, ro, rd), t, **kw)
    return {k: gather_rays(mesh, v, n_rays + pad)[:n_rays]
            for k, v in out.items()}


def render_pano(rend, pose, t, H, W, intrinsics_lidar, intrinsics_hoz_lidar,
                occ_kwargs=None, mesh=None):
    """One LiDAR pano at ``pose`` [4, 4] and time ``t`` -> tensors
    {"depth", "raydrop", "intensity"} of [H, W] on the renderer's device.
    ``occ_kwargs`` come from ``Trainer._occ_kwargs``."""
    fov = tuple(map(float, intrinsics_lidar))
    fov_hoz = tuple(map(float, intrinsics_hoz_lidar))

    def rays(pose):
        inds = torch.arange(H * W, dtype=torch.int32, device=pose.device)
        return raylib.get_lidar_rays(pose, inds, H, W, fov, fov_hoz)

    out = _render_frame(rend, rays, ("lidar", H, W, fov, fov_hoz), H * W,
                        {"pose": pose}, t, mesh, cal_lidar_color=True,
                        **(occ_kwargs or {}))
    img = out["image_lidar"]
    return {"depth": out["depth_lidar"].reshape(H, W),
            "raydrop": img[:, 0].reshape(H, W),
            "intensity": img[:, 1].reshape(H, W)}


def render_view(rend, pose, t, H, W, intrinsics, occ_kwargs=None, mesh=None):
    """One camera view -> tensors {"rgb" [H, W, 3], "depth" [H, W]} on the
    renderer's device, over a white background."""
    def rays(pose, intrinsics):
        inds = torch.arange(H * W, dtype=torch.int32, device=pose.device)
        return raylib.get_camera_rays(pose, inds, H, W, intrinsics)

    out = _render_frame(rend, rays, ("camera", H, W), H * W,
                        {"pose": pose, "intrinsics": intrinsics}, t, mesh,
                        cal_lidar_color=False, bg_color=1.0,
                        **(occ_kwargs or {}))
    return {"rgb": out["image"].reshape(H, W, 3),
            "depth": out["depth"].reshape(H, W)}


def _stack(frames, keys):
    return {k: np.stack([f[k].float().cpu().numpy() for f in frames])
            for k in keys}


def render_lidar_sweep(rend, poses, times, H, W, intrinsics_lidar,
                       intrinsics_hoz_lidar, occ_kwargs=None, mesh=None):
    """LiDAR panos for F poses [F, 4, 4] and times [F] -> numpy arrays
    depth, raydrop, intensity of [F, H, W]."""
    frames = [render_pano(rend, p, t, H, W, intrinsics_lidar,
                          intrinsics_hoz_lidar, occ_kwargs, mesh)
              for p, t in zip(poses, times)]
    return _stack(frames, ("depth", "raydrop", "intensity"))


def render_camera_sweep(rend, poses, times, H, W, intrinsics,
                        occ_kwargs=None, mesh=None):
    """Camera frames for F poses -> numpy rgb [F, H, W, 3], depth
    [F, H, W]."""
    frames = [render_view(rend, p, t, H, W, intrinsics, occ_kwargs, mesh)
              for p, t in zip(poses, times)]
    return _stack(frames, ("rgb", "depth"))
