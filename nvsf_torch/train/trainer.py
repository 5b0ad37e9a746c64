"""Trainer: the joint LiDAR + camera training step, the epoch loop, EMA, the
occupancy refresh, the eval renders, checkpoints and the U-Net refine stage
(counterpart of ``nvsf_tpu/train/trainer.py``).

The step samples rays on the device (random, or patch with error-map
weighting on patch epochs), renders each enabled branch through the
occupancy-compacted renderer (``render_mode="occupancy"``) or the dense
uniform one (any other mode, the default ``"uniform"``), sums the losses
(LiDAR depth / intensity / ray-drop, chamfer, scene flow, URF line of
sight, the patch structural regularizers on patch epochs, camera RGB),
runs Adam and updates the error maps. Semantics follow the JAX step
(``nvsf_tpu/train/trainer.py:383-611``); with ``joint_fusion`` the two
branches render in one ``Renderer.run_joint`` pass, as there:

  - Adam(0.9, 0.99, eps 1e-15) after zeroing NaN gradients, flow /
    intensity / ray-drop at 0.1x the learning rate, decay
    0.1 ** min(step / iters, 1);
  - EMA(0.95) of the parameters once per epoch;
  - patch epochs every ``change_patch_size_epoch`` epochs (counted from
    1), error-map sampling on patch epochs only;
  - in occupancy mode, the occupancy grids refreshed by the host every
    ``occ_update_interval`` steps, outside the step: between the scanned
    epoch's dispatches (``train_one_epoch(use_scan=True)``, the default;
    on the card each step replays a captured CUDA graph,
    ``train/step_graph.py``), or after each step (``use_scan=False``); on
    the card each refresh replays a captured CUDA graph
    (``train/graphs.py``).

Every random draw of a step can be injected through ``draws`` (see
``loss_and_grads``), so tests can replay the JAX package's draws.

The step's parts are spans (``train/profiler.py``): ``sample``,
``render`` (``render/renderer.py``), the field's ``encode.*`` and ``mlp``,
``loss``, ``backward`` and ``optim``, and the refresh is ``refresh``; the
host's work around each step is timed by ``timers.span``
(``step.dispatch``, ``epoch.sums``, ``refresh.dispatch``, ``ema``,
``epoch.sync``; on the card ``step.dispatch`` holds ``step.fill``,
``step.hold_grads``, ``step.replay`` and ``step.end_step``).

With a ``mesh`` (``nvsf_torch.parallel.mesh``) the step is one global step
split by rays across the mesh's ranks, as the JAX package's sharded step
(``nvsf_tpu/train/trainer.py:395-430``): every rank draws the whole batch,
renders its slice of the rays, gathers the outputs the losses read and
computes the whole batch's loss, and the gradients are averaged over the
ranks before Adam. Rank 0 broadcasts the parameters, EMA, grids and error
maps at construction, its error-map rows and grids after each update and
its U-Net after the refine stage; it alone writes checkpoints and traces.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from nvsf_torch import bridge
from nvsf_torch.config import NVSFConfig
from nvsf_torch.data import sampler
from nvsf_torch.data.dataset import SceneData
from nvsf_torch.lib import convert
from nvsf_torch.lib import pointcloud as pclib
from nvsf_torch.lib import rays as raylib
from nvsf_torch.lib.color import srgb_to_linear
from nvsf_torch.models.field import FieldSpec, NVSFField
from nvsf_torch.models.unet import UNet
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.parallel.mesh import (all_reduce_grads, gather_rays,
                                      replicate, shard_rays)
from nvsf_torch.render import sweep
from nvsf_torch.render.renderer import Renderer
from nvsf_torch.train import checkpoint as ckpt
from nvsf_torch.train import losses as L
from nvsf_torch.train.graphs import Program
from nvsf_torch.train.profiler import PhaseTimers, device_trace, span
from nvsf_torch.train.refine import apply_refinement, refine_raydrop


def field_spec_from_config(cfg: NVSFConfig) -> FieldSpec:
    return FieldSpec(
        min_resolution=cfg.min_resolution,
        base_resolution=cfg.base_resolution,
        max_resolution=cfg.max_resolution,
        time_resolution=cfg.time_resolution,
        n_levels_plane=cfg.n_levels_plane,
        n_features_per_level_plane=cfg.n_features_per_level_plane,
        n_levels_hash=cfg.n_levels_hash,
        n_features_per_level_hash=cfg.n_features_per_level_hash,
        log2_hashmap_size=cfg.log2_hashmap_size,
        hash_size_dynamic=tuple(cfg.hash_size_dynamic),
        num_layers_flow=cfg.num_layers_flow,
        hidden_dim_flow=cfg.hidden_dim_flow,
        flow_n_levels=cfg.flow_n_levels,
        flow_n_features_per_level=cfg.flow_n_features_per_level,
        flow_base_resolution=cfg.flow_base_resolution,
        flow_max_resolution=cfg.flow_max_resolution,
        flow_log2_hashmap_size=cfg.flow_log2_hashmap_size,
        num_layers_sigma=cfg.num_layers_sigma,
        hidden_dim_sigma=cfg.hidden_dim_sigma,
        geo_feat_dim=cfg.geo_feat_dim,
        num_layers_lidar=cfg.num_layers_color,
        hidden_dim_lidar=cfg.hidden_dim_lidar,
        num_layers_color=cfg.num_layers_color,
        num_frames=cfg.num_frames,
        bound=cfg.bound)


def compute_dtype_of(cfg: NVSFConfig) -> torch.dtype:
    """bf16 when the config trains in half precision (``--fp16``)."""
    if cfg.fp16 or cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    return torch.float32


def make_optimizer(cfg: NVSFConfig, field: NVSFField):
    """Adam(0.9, 0.99, eps 1e-15) with the slow group at 0.1x and the
    decay 0.1 ** min(step / iters, 1); call ``zero_nan_grads`` before each
    step. Returns (optimizer, scheduler).

    On the card Adam is ``capturable`` with learning rates held in device
    tensors, which the scheduler fills in place: a captured step
    (``train/step_graph.py``) reads them at every replay. On the CPU it is
    torch's default Adam (capturable Adam refuses CPU tensors)."""
    base, slow = field.lr_groups()
    dev = base[0].device
    capturable = dev.type == "cuda"

    def lr(v):
        return torch.tensor(v, dtype=torch.float32, device=dev) \
            if capturable else v

    opt = torch.optim.Adam([{"params": base, "lr": lr(cfg.lr)},
                            {"params": slow, "lr": lr(0.1 * cfg.lr)}],
                           betas=(0.9, 0.99), eps=1e-15,
                           capturable=capturable)
    iters = max(cfg.iters, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda s: 0.1 ** min(s / iters, 1.0))
    return opt, sched


def zero_nan_grads(params) -> None:
    """NaN gradients become 0, and a parameter without a gradient gets a
    zero one, so that Adam moves every parameter every step (optax's
    ``zero_nans`` + ``scale_by_adam`` over the whole tree)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            torch.nan_to_num_(p.grad, nan=0.0, posinf=float("inf"),
                              neginf=float("-inf"))


@dataclass
class EpochStats:
    loss: float
    parts: Dict[str, float]


_SR_FLAGS = ("grad_norm_smooth", "spatial_smooth", "tv_loss", "grad_loss")


def _row(t: torch.Tensor, fi: torch.Tensor) -> torch.Tensor:
    """``t[fi]`` for a device scalar index, with no host synchronisation
    (indexing by a 0-d tensor reads it on the host)."""
    return t.index_select(0, fi.reshape(1))[0]


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; with no card only an explicit ``"cpu"``
    runs, so a missing card never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nvsf_torch runs on the card by default and no CUDA device is "
            "present (torch.cuda.is_available() is False); pass "
            "device='cpu' to run on the CPU")
    return dev


class Trainer:
    """Host loop around the training step, on one ``device`` (the card
    unless ``device="cpu"``), or on this rank's device of a data-parallel
    ``mesh``. Checkpoints go to ``cfg.workspace/checkpoints`` as
    ``{cfg.name}_*.pkl``."""

    def __init__(self, cfg: NVSFConfig, scene: SceneData, seed: int = 0,
                 device=None, mesh=None):
        self.joint = cfg.enable_lidar and cfg.enable_rgb and cfg.joint_fusion
        if self.joint:
            # the fused path evaluates both branches in one density batch:
            # per-branch sample budgets and the chunked remat query do not
            # exist there (the JAX package's guards and messages)
            if cfg.num_steps_occ_rgb and \
                    cfg.num_steps_occ_rgb != cfg.num_steps_occ:
                raise ValueError(
                    "joint_fusion=True fuses both branches into one density "
                    f"batch and cannot honor num_steps_occ_rgb="
                    f"{cfg.num_steps_occ_rgb} != num_steps_occ="
                    f"{cfg.num_steps_occ}; unset num_steps_occ_rgb or "
                    "disable joint_fusion")
            if cfg.remat_chunks > 1:
                raise ValueError(
                    "joint_fusion=True bypasses the remat_chunks chunked "
                    "density query (run_joint evaluates the full joint "
                    "batch); set remat_chunks=1 or disable joint_fusion")
        self.cfg = cfg
        self.scene = scene
        self.workspace = cfg.workspace
        self.name = cfg.name
        self.mesh = mesh
        self.device = dev = resolve_device(
            mesh.device if mesh is not None and device is None else device)

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        n = len(scene)
        d = {"times": t(scene.times)}
        if cfg.enable_lidar:
            d["poses_lidar"] = t(scene.poses_lidar)
            if scene.images_lidar is not None:
                self._check_far_plane(scene.images_lidar)
                d["panos_flat"] = t(scene.images_lidar).reshape(n, -1, 3)
                if self.sr_enabled():
                    # the GT panos' double gradients, once per frame
                    gxx, gyy = L.pano_double_gradients(
                        t(scene.images_lidar[..., 2]), cfg.scale)
                    d["pano_gxx_flat"] = gxx.reshape(n, -1)
                    d["pano_gyy_flat"] = gyy.reshape(n, -1)
        if cfg.enable_rgb and scene.poses is not None:
            d["poses"] = t(scene.poses)
            if scene.images is not None:
                d["images_flat"] = t(scene.images).reshape(
                    n, -1, scene.images.shape[-1])
            if scene.image_depths is not None:
                d["image_depths_flat"] = t(scene.image_depths).reshape(n, -1)
            d["intrinsics"] = t(scene.intrinsics)
        self.data = d

        self.pc_data = None
        if cfg.flow_loss and cfg.enable_lidar \
                and scene.images_lidar is not None:
            self.pc_data = self._process_pointclouds()

        # occupancy grids (one per enabled branch) in occupancy mode; the
        # dense uniform mode has none
        self.occ = None
        if cfg.render_mode == "occupancy":
            self.occ = OccupancyGrid(
                grid_size=cfg.occ_grid_size, bound=cfg.bound,
                decay=cfg.occ_decay,
                update_fraction=cfg.occ_update_fraction)
        init_gen = torch.Generator().manual_seed(seed)
        self.field = NVSFField(
            field_spec_from_config(cfg), generator=init_gen,
            table_grad_precision="bf16" if cfg.fp16 else "f32").to(dev)
        self.renderer = Renderer(
            field=self.field, bound=cfg.bound,
            density_scale=cfg.density_scale, min_near=cfg.min_near,
            min_near_lidar=cfg.min_near_lidar,
            lidar_max_depth=cfg.lidar_max_depth,
            active_sensor=cfg.active_sensor, num_steps=cfg.num_steps,
            compute_dtype=compute_dtype_of(cfg),
            remat_chunks=cfg.remat_chunks, occ_jitter=cfg.occ_jitter,
            occ_delta_clamp=cfg.occ_delta_clamp,
            max_ray_batch=cfg.max_ray_batch, stream_slab=cfg.stream_slab)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.field)
        # the EMA of the parameters lives in a second field, so that eval
        # renders it without touching the trained parameters
        self.ema_field = copy.deepcopy(self.field).requires_grad_(False)
        self.ema = dict(self.ema_field.named_parameters())
        self.ema_renderer = dataclasses.replace(self.renderer,
                                                field=self.ema_field)
        self.error_map = self.error_map_rgb = None
        self.occ_grid_lidar = self.occ_grid_rgb = None
        if cfg.enable_lidar:
            self.error_map = torch.ones(
                (n, scene.H_lidar // 2, scene.W_lidar // 2), device=dev)
            if self.occ is not None:
                self.occ_grid_lidar = self.occ.init(dev)
        if cfg.enable_rgb:
            self.error_map_rgb = torch.ones(
                (n, scene.H // 4, scene.W // 4), device=dev)
            if self.occ is not None:
                self.occ_grid_rgb = self.occ.init(dev)
        self.generator = torch.Generator(device=dev).manual_seed(seed)
        # the occupancy refresh's draws: one generator, reseeded in place
        # before each refresh, so that its captured graph (registered with
        # it) draws what an eager refresh draws from the same seed
        self.occ_generator = torch.Generator(device=dev)
        self._order_rng = np.random.default_rng(seed)
        # the step's frame index and global step as device scalars: the
        # host fills them before each step, so a captured step reads them
        # at every replay (``train/step_graph.py``)
        self._fi = torch.zeros((), dtype=torch.int64, device=dev)
        self._step_t = torch.zeros((), dtype=torch.int64, device=dev)
        # the captured steps (on the card, made by the first scanned epoch)
        self.step_graphs = None
        # the other captured programs on the card (``train/graphs.py``): the
        # refresh and the mesh export's density query, by key
        self.programs: Dict[tuple, Program] = {}
        self.epoch = 0
        self.global_step = 0
        self.stats = {"results": [], "best_result": None}
        # tick 0 counts as refreshed: the first refresh fires once
        # global_step crosses occ_update_interval
        self._last_occ_update = 0
        self.occ_refresh_count = 0
        self._profiled = False
        # wall time by stage (refine render, U-Net steps, the CLI's
        # epochs, evals, test renders and mesh)
        self.timers = PhaseTimers(
            torch.cuda.synchronize if dev.type == "cuda" else None)
        # the U-Net raydrop refiner, trained only by ``refine``
        self.unet = UNet(in_channels=3, channels=32, out_channels=1,
                         generator=init_gen).to(dev).eval()
        self.unet_trained = False
        # paths of the checkpoints this process wrote (rank 0's under a
        # mesh)
        self.checkpoints_written = []
        if mesh is not None:
            replicate(mesh, self.replicated_state().values())

    @property
    def global_step(self) -> int:
        """Steps taken; mirrored into the device scalar the step reads."""
        return self._global_step

    @global_step.setter
    def global_step(self, value: int) -> None:
        self._global_step = int(value)
        self._step_t.fill_(self._global_step)

    def drop_step_graphs(self) -> None:
        """Forget the captured steps (the next scanned epoch captures
        anew), the captured refresh and density query and both renderers'
        captured frame renders, which frees their memory pools: a graph
        reads every tensor at the address it had at capture, and a load
        installs new error maps, grids and Adam moments."""
        self.step_graphs = None
        self.programs.clear()
        self.renderer.drop_frame_graphs()
        self.ema_renderer.drop_frame_graphs()

    @property
    def is_main(self) -> bool:
        """Whether this process writes (no mesh, or its rank 0)."""
        return self.mesh is None or self.mesh.is_main

    def replicated_state(self) -> Dict[str, torch.Tensor]:
        """Every tensor that the ranks of a mesh hold alike, by name: the
        parameters, their EMA, Adam's moments, the U-Net, the occupancy
        grids and the error maps."""
        named = {f"field.{k}": p for k, p in self.field.named_parameters()}
        named.update({f"ema.{k}": p for k, p in self.ema.items()})
        for k, p in self.field.named_parameters():
            st = self.optimizer.state.get(p, {})
            named.update({f"adam.{m}.{k}": st[m] for m in
                          ("exp_avg", "exp_avg_sq") if m in st})
        named.update({f"unet.{k}": t for k, t in
                      (*self.unet.named_parameters(),
                       *self.unet.named_buffers())})
        for k in ("occ_grid_lidar", "occ_grid_rgb", "error_map",
                  "error_map_rgb"):
            if getattr(self, k) is not None:
                named[k] = getattr(self, k)
        return named

    # ------------------------------------------------------------------
    def _check_far_plane(self, panos: np.ndarray) -> None:
        """Refuse a LiDAR far plane below the 99th percentile of the GT
        depths: those returns could never be supervised (the signature of
        near/far scaled twice)."""
        hit = panos[..., 0] > 0.5
        if hit.any():
            q99 = float(np.quantile(panos[..., 2][hit], 0.99))
            if q99 > float(self.cfg.lidar_max_depth):
                raise ValueError(
                    f"lidar_max_depth={self.cfg.lidar_max_depth:.4g} "
                    f"(scaled) truncates the GT depth distribution "
                    f"(p99={q99:.4g}): >=1% of returns lie beyond the far "
                    "plane and can never be supervised. Near/far are "
                    "scaled by NVSFConfig.finalize() exactly once — pass "
                    "METERS through finalize(), or scaled values without "
                    "it.")

    def _process_pointclouds(self):
        """pano -> LiDAR points -> ground removal -> scaled world clouds,
        padded, indexed by global frame."""
        cfg, scene = self.cfg, self.scene
        clouds = [np.zeros((0, 3), np.float32)] * scene.num_frames
        valid = np.zeros(scene.num_frames, bool)
        for i in range(len(scene)):
            pano = scene.images_lidar[i]
            gt_depth = pano[:, :, 2] * pano[:, :, 0] / cfg.scale
            pts = convert.pano_to_lidar(gt_depth, scene.intrinsics_lidar,
                                        scene.intrinsics_hoz_lidar)
            points, _ground = pclib.point_removal(
                pts, dist_min=1.0,
                dist_max=0.75 * cfg.lidar_max_depth / cfg.scale,
                z_limit=[-2.5, 4])
            pw = points * cfg.scale
            pw = (scene.poses_lidar[i] @ np.hstack(
                [pw, np.ones((len(pw), 1), np.float32)]).T).T[:, :3]
            gfi = int(round(float(scene.times[i]) * (cfg.num_frames - 1)))
            clouds[gfi] = pw.astype(np.float32)
            valid[gfi] = True
        arr, mask = pclib.pad_pointclouds(clouds)
        dev = self.device
        return {"pc": torch.as_tensor(arr, device=dev),
                "pc_mask": torch.as_tensor(mask, device=dev),
                "pc_valid": torch.as_tensor(valid, device=dev)}

    def patch_enabled(self) -> bool:
        patch = tuple(self.cfg.change_patch_size_lidar)
        return bool(patch) and patch[0] > 1

    def sr_enabled(self) -> bool:
        """Whether a patch structural regularizer is on."""
        return any(getattr(self.cfg, f) for f in _SR_FLAGS)

    def set_schedule(self, step: int) -> None:
        """Put the learning-rate decay at ``step`` (a resumed run); tensor
        learning rates (capturable Adam) are filled in place."""
        sched = self.scheduler
        sched.last_epoch = step
        lrs = [base * fn(step)
               for base, fn in zip(sched.base_lrs, sched.lr_lambdas)]
        for group, lr in zip(self.optimizer.param_groups, lrs):
            if torch.is_tensor(group["lr"]):
                group["lr"].fill_(lr)
            else:
                group["lr"] = lr
        sched._last_lr = lrs

    # ------------------------------------------------------------------
    def _frame_index(self, fi) -> torch.Tensor:
        """A frame index as the device scalar the step reads: an int is
        written into it, a tensor (the captured step's static input) is
        the scalar itself."""
        if torch.is_tensor(fi):
            return fi
        self._fi.fill_(int(fi))
        return self._fi

    def loss_and_grads(self, fi, patch: bool, draws: Optional[dict] = None):
        """Forward and backward of one step on frame ``fi`` (an int, or the
        int64 device scalar of the frame); leaves the gradients in
        ``.grad``. Returns (loss, parts, error-map inputs). Nothing in it
        synchronises with the host, so it can be captured.

        ``draws`` replaces the step's random draws: ``lidar_rays`` /
        ``rgb_rays`` (sampler draws), ``lidar_render`` / ``rgb_render``
        (``z_noise`` [N, T], ``jitter_u`` [N, K]) and ``bg`` [N, 3].

        Under a mesh every draw is made (or given) at the batch's full N,
        this rank renders its slice of the rays, the outputs the losses
        read are gathered, and the loss, its parts and the gradients left
        in ``.grad`` are the whole batch's."""
        cfg, scene, data = self.cfg, self.scene, self.data
        dev, gen, rend = self.device, self.generator, self.renderer
        fi = self._frame_index(fi)
        draws = draws or {}
        Hl, Wl = scene.H_lidar, scene.W_lidar
        H, W = scene.H, scene.W
        patch_hw = tuple(cfg.change_patch_size_lidar) if patch else (1, 1)
        use_em = cfg.use_error_map and patch
        crit = {k: L.make_criterion(getattr(cfg, a), cfg.scale)
                for k, a in (("rgb", "rgb_loss"), ("depth", "depth_loss"),
                             ("rgb_depth", "rgb_depth_loss"),
                             ("raydrop", "raydrop_loss"),
                             ("intensity", "intensity_loss"))}
        parts, em_inputs = {}, {}

        with span("sample", dev):
            t = _row(data["times"], fi)
            if cfg.enable_lidar:
                inds = sampler.sample_indices(
                    Hl, Wl, cfg.num_rays_lidar,
                    patch_size=patch_hw if patch else 1,
                    error_map=_row(self.error_map, fi) if use_em else None,
                    use_error_map=use_em, generator=gen,
                    draws=draws.get("lidar_rays"), device=dev)
                ro, rd = raylib.get_lidar_rays(
                    _row(data["poses_lidar"], fi), inds, Hl, Wl,
                    scene.intrinsics_lidar, scene.intrinsics_hoz_lidar)
                gt = _row(data["panos_flat"], fi)[inds]
            if cfg.enable_rgb:
                inds_c = sampler.sample_indices(
                    H, W, cfg.num_rays, patch_size=cfg.patch_size,
                    error_map=_row(self.error_map_rgb, fi) if use_em else None,
                    use_error_map=use_em, generator=gen,
                    draws=draws.get("rgb_rays"), device=dev)
                ro_c, rd_c = raylib.get_camera_rays(_row(data["poses"], fi),
                                                    inds_c, H, W,
                                                    data["intrinsics"])
                gt_rgb = _row(data["images_flat"], fi)[inds_c]
                if cfg.color_space == "linear":
                    gt_rgb = torch.cat([srgb_to_linear(gt_rgb[..., :3]),
                                        gt_rgb[..., 3:]], dim=-1)
                bg = 1.0
                if gt_rgb.shape[-1] == 4:
                    bg = draws.get("bg")
                    if bg is None:
                        bg = torch.rand((cfg.num_rays, 3), generator=gen,
                                        device=dev)
                    gt_rgb = gt_rgb[..., :3] * gt_rgb[..., 3:] \
                        + bg * (1 - gt_rgb[..., 3:])

            pc = None
            if cfg.flow_loss and self.pc_data is not None:
                gfi = torch.round(t * (cfg.num_frames - 1)).long()
                pc = _row(self.pc_data["pc"], gfi)
                pcm = _row(self.pc_data["pc_mask"], gfi)

            # each branch's rays and K, and its render draws at the batch's
            # full shape (a rank of a mesh draws what a single process does)
            n_rays, K = {}, {}
            if cfg.enable_lidar:
                n_rays["lidar"] = ro.shape[0]
                K["lidar"] = cfg.num_steps_occ
            if cfg.enable_rgb:
                n_rays["rgb"] = ro_c.shape[0]
                K["rgb"] = cfg.num_steps_occ if self.joint \
                    else cfg.num_steps_occ_rgb or cfg.num_steps_occ
            rdraws = {b: rend.render_noise(
                n, K[b] if self.occ is not None else None, gen, dev,
                draws.get(f"{b}_render")) for b, n in n_rays.items()}

        def render(branch, ro, rd, lidar, bg_color=None):
            ro, rd, dr, bg_color = self._local_rays(ro, rd, rdraws[branch],
                                                    bg_color)
            if self.occ is None:
                out = rend.run(ro, rd, t, cal_lidar_color=lidar,
                               perturb=True, generator=gen,
                               z_noise=dr["z_noise"], bg_color=bg_color)
            else:
                out = rend.run_occupancy(
                    ro, rd, t, self.occ, getattr(self, f"occ_grid_{branch}"),
                    num_steps_occ=K[branch], cal_lidar_color=lidar,
                    perturb=True,
                    generator=gen, z_noise=dr["z_noise"],
                    jitter_u=dr.get("jitter_u"), occ_thresh=cfg.occ_thresh,
                    bg_color=bg_color)
            return self._gather_outputs(out, lidar, n_rays[branch])

        fl = None
        if self.joint:
            # the flow loss's cloud rides in the joint flow batch (the
            # whole cloud on every rank of a mesh)
            ro_l, rd_l, dr_l, _ = self._local_rays(ro, rd, rdraws["lidar"])
            ro_cl, rd_cl, dr_c, bg_l = self._local_rays(ro_c, rd_c,
                                                        rdraws["rgb"], bg)
            out, out_c, extra = rend.run_joint(
                ro_l, rd_l, ro_cl, rd_cl, t, perturb=True, generator=gen,
                draws_l=dr_l, draws_c=dr_c, bg_color=bg_l, occ=self.occ,
                occ_grid_l=self.occ_grid_lidar, occ_grid_c=self.occ_grid_rgb,
                num_steps_occ=K["lidar"], occ_thresh=cfg.occ_thresh,
                x_flow_extra=pc)
            out = self._gather_outputs(out, True, n_rays["lidar"])
            out_c = self._gather_outputs(out_c, False, n_rays["rgb"])
            fl = extra.get("flow_extra")
        else:
            if cfg.enable_lidar:
                out = render("lidar", ro, rd, True)
            if cfg.enable_rgb:
                out_c = render("rgb", ro_c, rd_c, False, bg_color=bg)

        with span("loss", dev, backward=True) as s:
            total = torch.zeros((), device=dev)
            if cfg.enable_lidar:
                gt_raydrop = gt[:, 0]
                gt_intensity = gt[:, 1] * gt_raydrop
                gt_depth = gt[:, 2] * gt_raydrop
                pred_raydrop = out["image_lidar"][:, 0]
                pred_intensity = out["image_lidar"][:, 1] * gt_raydrop
                pred_depth = out["depth_lidar"] * gt_raydrop
                if cfg.raydrop_loss == "bce":
                    pred_raydrop = torch.sigmoid(pred_raydrop)
                lidar_loss, lparts = L.lidar_losses(
                    pred_raydrop, pred_intensity, pred_depth, gt_raydrop,
                    gt_intensity, gt_depth, crit, cfg.alpha_d, cfg.alpha_i,
                    cfg.alpha_r, cfg.smooth_factor)
                parts.update(lparts)
                total = total + lidar_loss.sum()
                cd = L.lidar_chamfer_loss(rd, pred_depth, gt_depth, cfg.scale)
                parts["chamfer"] = cd
                total = total + cd
                if pc is not None:
                    if fl is None:
                        fl = self.field.flow_at(pc, t)
                    pcd = self.pc_data
                    nxt = torch.clamp(gfi + 1, max=cfg.num_frames - 1)
                    prv = torch.clamp(gfi - 1, min=0)
                    has_next = (gfi < cfg.num_frames - 1) \
                        & _row(pcd["pc_valid"], nxt)
                    has_prev = (gfi > 0) & _row(pcd["pc_valid"], prv)
                    fwd = L.flow_consistency_loss(
                        pc, pcm, _row(pcd["pc"], nxt),
                        _row(pcd["pc_mask"], nxt), fl["flow_forward"])
                    bwd = L.flow_consistency_loss(
                        pc, pcm, _row(pcd["pc"], prv),
                        _row(pcd["pc_mask"], prv), fl["flow_backward"])
                    fl_loss = torch.where(has_next, fwd, 0.0) \
                        + torch.where(has_prev, bwd, 0.0)
                    parts["flow"] = fl_loss
                    total = total + fl_loss
                if cfg.use_urf_loss:
                    urf = L.urf_line_of_sight_loss(
                        out["weights"], out["z_vals"], gt_depth,
                        self._step_t, cfg.iters)
                    parts["urf"] = urf
                    total = total + urf
                if patch and self.sr_enabled():
                    sr = self._structural_loss(fi, inds, out["depth_lidar"],
                                               gt, patch_hw)
                    parts["loss_sr"] = sr
                    total = total + sr
                em_inputs["lidar"] = (inds, lidar_loss.detach())

            if cfg.enable_rgb:
                rgb_l = cfg.alpha_rgb * crit["rgb"](out_c["image"],
                                                    gt_rgb[..., :3])
                parts["rgb"] = rgb_l.sum()
                total = total + rgb_l.sum()
                if cfg.use_rgbd_loss and "image_depths_flat" in data:
                    gt_d = _row(data["image_depths_flat"], fi)[inds_c] \
                        * cfg.scale
                    max_d = 80 * cfg.scale
                    gt_d = torch.clamp(gt_d, max=max_d)
                    pd_c = torch.clamp(out_c["depth"], max=max_d)
                    m = (gt_d > 0).to(torch.float32)
                    rd_l = cfg.alpha_rd * crit["rgb_depth"](pd_c * m, gt_d * m)
                    parts["rgb_d"] = rd_l.sum()
                    total = total + rd_l.sum()
                em_inputs["rgb"] = (inds_c, rgb_l.sum(-1).detach())

            loss = s.out(L.scrub_loss(total))
        with span("backward", dev):
            loss.backward()
        if self.mesh is not None:
            all_reduce_grads(self.mesh, self.field.parameters())
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, \
            em_inputs

    def _local_rays(self, ro, rd, dr, bg=None):
        """This rank's slice of a branch's rays, render draws and
        background [N, 3]; all of them without a mesh."""
        if self.mesh is None:
            return ro, rd, dr, bg
        ro, rd = shard_rays(self.mesh, ro, rd)
        dr = {k: shard_rays(self.mesh, v)[0] for k, v in dr.items()}
        if torch.is_tensor(bg) and bg.dim():
            bg = shard_rays(self.mesh, bg)[0]
        return ro, rd, dr, bg

    def _gather_outputs(self, out: dict, lidar: bool, n: int) -> dict:
        """Under a mesh, the render outputs the losses read, whole on every
        rank; ``out`` itself without one."""
        if self.mesh is None:
            return out
        cfg = self.cfg
        if lidar:
            keys = ["image_lidar", "depth_lidar"] + (
                ["weights", "z_vals"] if cfg.use_urf_loss else [])
        else:
            keys = ["image"] + (["depth"] if cfg.use_rgbd_loss else [])
        return {k: gather_rays(self.mesh, out[k], n) for k in keys}

    def _structural_loss(self, fi, inds, depth_lidar, gt, patch_hw):
        """The patch structural regularizers of a patch step, on the rendered
        and GT depth of its patches in meters, the gradient loss masked to
        where the GT pano's double gradients are below 0.05."""
        cfg = self.cfg
        ph, pw = patch_hw
        shape = (cfg.num_rays_lidar // (ph * pw), ph, pw)
        gmx, gmy = ((_row(self.data[k], fi)[inds].abs() < 0.05)
                    .to(torch.float32).reshape(shape)
                    for k in ("pano_gxx_flat", "pano_gyy_flat"))
        flags = {f: getattr(cfg, f) for f in _SR_FLAGS + (
            "sobel_grad", "alpha_grad_norm", "alpha_spatial", "alpha_tv",
            "alpha_grad")}
        flags["depth_grad_loss_is_cos"] = cfg.depth_grad_loss == "cos"
        return L.structural_regularizers(
            (depth_lidar / cfg.scale).reshape(shape),
            (gt[:, 2] / cfg.scale).reshape(shape), gt[:, 0].reshape(shape),
            gmx, gmy, L.make_criterion(cfg.depth_grad_loss, cfg.scale), flags)

    def train_step(self, fi, patch: bool,
                   draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on frame ``fi``, eagerly; returns detached
        scalar metrics (no host synchronisation)."""
        metrics = self.step_body(self._frame_index(fi), patch, draws)
        self.end_step()
        return metrics

    def step_body(self, fi: torch.Tensor, patch: bool,
                  draws: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """What one captured step replays: gradients zeroed in place, the
        forward and backward, NaN gradients zeroed, Adam, the error-map
        rows of frame ``fi`` (the int64 device scalar). Under a mesh it
        also all-reduces the gradients and broadcasts rank 0's rows."""
        with span("optim", self.device):
            self.optimizer.zero_grad(set_to_none=False)
        loss, parts, em_inputs = self.loss_and_grads(fi, patch, draws)
        with span("optim", self.device):
            zero_nan_grads(self.field.parameters())
            self.optimizer.step()
            with torch.no_grad():
                scene = self.scene
                for key, em, H, W in (("lidar", self.error_map,
                                       scene.H_lidar, scene.W_lidar),
                                      ("rgb", self.error_map_rgb, scene.H,
                                       scene.W)):
                    if key not in em_inputs:
                        continue
                    inds, err = em_inputs[key]
                    row = sampler.update_error_map(_row(em, fi), inds, err,
                                                   H, W)
                    if self.mesh is not None:
                        # duplicate cells of the batch take any of their
                        # writes
                        replicate(self.mesh, [row], "error map")
                    em.index_copy_(0, fi.reshape(1), row[None])
        return {"loss": loss, **parts}

    def end_step(self) -> None:
        """The host's part of a step, after its device work: the schedule
        moves on (filling capturable Adam's learning rates in place) and
        ``global_step`` counts the step."""
        self.scheduler.step()
        self.global_step += 1

    # ------------------------------------------------------------------
    def train_one_epoch(self, order=None, use_scan: bool = True) -> EpochStats:
        """One pass over ``order`` (default: a seeded permutation of the
        frames); a patch epoch when ``epoch`` is a positive multiple of
        ``change_patch_size_epoch``. With ``cfg.profile_dir`` the first
        warm epoch (epoch 2, or 1 when there is one) is traced there.

        ``use_scan`` (the default) is the JAX package's scanned epoch
        (``nvsf_tpu/train/trainer.py:694-736``): in occupancy mode an
        epoch longer than ``occ_update_interval`` runs in dispatches of
        that many steps counted from its start, the grids refreshed only
        between them; a shorter one, or any epoch without grids, is one
        dispatch. On the card each step of a dispatch replays a captured
        CUDA graph (``train/step_graph.py``); on the CPU it runs eagerly.
        ``use_scan=False`` is its step path: every step eager, the refresh
        checked after each."""
        trace = None
        if (self.cfg.profile_dir and not self._profiled
                and self.epoch >= min(self.cfg.epochs, 2)):
            self._profiled = True
            trace = self.cfg.profile_dir if self.is_main else None
        with device_trace(trace), self.timers.phase("train epoch"):
            return self._train_one_epoch(order, use_scan)

    def dispatches(self, order: np.ndarray, use_scan: bool):
        """The epoch's frame order cut where the grids may refresh: fixed
        chunks of ``occ_update_interval`` from the epoch's start when it is
        longer (the scanned epoch), one chunk otherwise, or one step a
        chunk (``use_scan=False``)."""
        if not use_scan:
            return [order[i:i + 1] for i in range(len(order))]
        n = self.cfg.occ_update_interval if self.occ is not None else 0
        if n > 0 and len(order) > n:
            return [order[i:i + n] for i in range(0, len(order), n)]
        return [order]

    def scan_step(self, fi: int, patch: bool) -> Dict[str, torch.Tensor]:
        """One step of a scanned epoch: a replay of the captured step on
        the card (its metrics are the graph's static outputs, overwritten
        by the next replay), an eager step on the CPU."""
        if self.device.type != "cuda":
            return self.train_step(int(fi), patch)
        if self.step_graphs is None:
            from nvsf_torch.train.step_graph import StepGraphs
            self.step_graphs = StepGraphs(self)
        return self.step_graphs.step(int(fi), patch)

    def _train_one_epoch(self, order=None, use_scan=True) -> EpochStats:
        cfg = self.cfg
        if order is None:
            order = self._order_rng.permutation(len(self.scene))
        order = np.asarray(order, np.int64)
        use_patch = (self.patch_enabled() and self.epoch > 0
                     and self.epoch % cfg.change_patch_size_epoch == 0)
        step = self.scan_step if use_scan else self.train_step
        timers = self.timers
        sums = {}
        for chunk in self.dispatches(order, use_scan):
            for fi in chunk:
                with timers.span("step.dispatch"):
                    metrics = step(int(fi), use_patch)
                with timers.span("epoch.sums"):
                    for k, v in metrics.items():
                        sums[k] = sums[k] + v if k in sums else v.clone()
            self.maybe_update_occ()
        with timers.span("ema"):
            self.update_ema()
        self.maybe_update_occ()
        with timers.span("epoch.sync"):
            parts = {k: float(v) / len(order) for k, v in sums.items()}
        return EpochStats(loss=parts["loss"], parts=parts)

    def train(self, max_epochs: Optional[int] = None,
              log_fn=print) -> EpochStats:
        """Epochs ``epoch + 1 .. max_epochs`` (default ``cfg.epochs``), a
        full checkpoint and a log line every ``eval_interval`` epochs and
        at the last (``nvsf_tpu/train/trainer.py:789-803``); returns the
        last epoch's stats (NaN loss when no epoch was left to run)."""
        cfg = self.cfg
        max_epochs = max_epochs or cfg.epochs
        t0 = time.time()
        stats = EpochStats(loss=float("nan"), parts={})
        for ep in range(self.epoch + 1, max_epochs + 1):
            self.epoch = ep
            stats = self.train_one_epoch()
            if ep % max(cfg.eval_interval, 1) == 0 or ep == max_epochs:
                self.save_checkpoint(full=True)
                if self.is_main:
                    log_fn(f"[epoch {ep}] loss={stats.loss:.5f} "
                           f"({time.time() - t0:.1f}s) parts="
                           + " ".join(f"{k}={v:.4f}"
                                      for k, v in stats.parts.items()
                                      if k != "loss"))
        return stats

    @torch.no_grad()
    def update_ema(self) -> None:
        """The JAX package's ``_update_ema`` (``nvsf_tpu/train/trainer.py:
        262-265``): ema = decay * ema + (1 - decay) * params over every
        parameter, as two multi-tensor kernels."""
        decay = self.cfg.ema_decay
        named = list(self.field.named_parameters())
        ema = [self.ema[k] for k, _ in named]
        with span("optim", self.device):
            torch._foreach_mul_(ema, decay)
            torch._foreach_add_(ema, [p.detach() for _, p in named],
                                alpha=1 - decay)

    def _occ_refresh_times(self, generator):
        """Stratified, jittered query times over the scene's time span."""
        S = max(int(self.cfg.occ_time_samples), 1)
        times = np.asarray(self.scene.times)
        t_lo, t_hi = float(times.min()), float(times.max())
        strata = torch.arange(S, dtype=torch.float32,
                              device=self.device) / S
        u = torch.rand((S,), generator=generator, device=self.device) / S
        return t_lo + (t_hi - t_lo) * (strata + u)

    def maybe_update_occ(self) -> None:
        """Refresh the occupancy grids when global_step has crossed a
        multiple of occ_update_interval since the last refresh."""
        cfg = self.cfg
        if self.occ is None or cfg.occ_update_interval <= 0:
            return
        tick = self.global_step // cfg.occ_update_interval
        if tick == self._last_occ_update:
            return
        self._last_occ_update = tick
        self.occ_refresh_count += 1
        with self.timers.span("refresh.dispatch"):
            self.refresh_occupancy(0xACC + self.global_step)

    def refresh_occupancy(self, seed: int,
                          graphed: Optional[bool] = None) -> None:
        """One refresh of every grid at stratified times, its draws from
        ``occ_generator`` seeded with ``seed`` (on every rank of a mesh,
        which then takes rank 0's grids: duplicate cells of the refresh
        take any of their writes). On the card (``graphed`` None or True)
        it replays the refresh captured as a CUDA graph, keyed by the grid
        spec and the branches (a replay refuses grids or parameters
        replaced since its capture); ``graphed=False`` is the eager refresh
        the graph is held to."""
        graphed = self.device.type == "cuda" if graphed is None else graphed
        self.occ_generator.manual_seed(int(seed))
        if graphed:
            self._refresh_program()()
        else:
            self._refresh_body()
        if self.mesh is not None:
            replicate(self.mesh, self._occ_grids(), "occupancy grid")

    def _occ_grids(self):
        return [g for g in (self.occ_grid_lidar, self.occ_grid_rgb)
                if g is not None]

    def _refresh_body(self) -> None:
        """The refresh's device work (JAX's ``_occ_update`` of each grid):
        the query times, then each grid's cells, jitter and update, in that
        order of draws; each grid is written in place, as a captured step
        and the frame graphs read it at its address."""
        gen = self.occ_generator
        with span("refresh", self.device):
            ts = self._occ_refresh_times(gen)
            for branch, lidar in (("lidar", True), ("rgb", False)):
                grid = getattr(self, f"occ_grid_{branch}")
                if grid is None:
                    continue
                grid.copy_(self.occ.update(
                    grid, lambda p, tt, lidar=lidar: self.field.density(
                        p, tt, cal_lidar_color=lidar,
                        skip_warp=True)["sigma"], ts, generator=gen))

    def _refresh_program(self) -> Program:
        key = ("refresh", dataclasses.astuple(self.occ),
               self.occ_grid_lidar is not None, self.occ_grid_rgb is not None)
        if key not in self.programs:
            self.programs[key] = Program(
                self._refresh_body, self.device,
                generators=[self.occ_generator],
                held=lambda: {**{k: getattr(self, k) for k in (
                    "occ_grid_lidar", "occ_grid_rgb")
                    if getattr(self, k) is not None},
                    **dict(self.field.named_parameters())})
        return self.programs[key]

    # ------------------------------------------------------------------
    # eval renders (``nvsf_tpu/train/trainer.py:624-666, 811-863, 913-921``)
    # ------------------------------------------------------------------
    @property
    def has_unet(self) -> bool:
        """Whether ``refine`` trained the U-Net (or a checkpoint of a
        refined run was loaded)."""
        return bool(self.unet_trained)

    def _occ_kwargs(self, occ_grid, lidar=False) -> dict:
        """Render kwargs of the occupancy-compacted early-exit marcher:
        LiDAR renders take the render-time budget ``num_steps_occ_render``,
        camera renders their training budget ``num_steps_occ_rgb`` (each
        falling back to ``num_steps_occ``)."""
        if occ_grid is None:
            return {}
        cfg = self.cfg
        if lidar:
            k = cfg.num_steps_occ_render or cfg.num_steps_occ
        else:
            k = cfg.num_steps_occ_rgb or cfg.num_steps_occ
        return dict(occ=self.occ, occ_grid=occ_grid, num_steps_occ=k,
                    occ_thresh=cfg.occ_thresh,
                    skip_warp=bool(cfg.render_skip_warp))

    def eval_renderer(self, use_ema: bool) -> Renderer:
        return self.ema_renderer if use_ema else self.renderer

    def render_pano(self, pose, t, H, W, intrinsics_lidar,
                    intrinsics_hoz_lidar, use_ema=False) -> dict:
        """A LiDAR pano at any pose, time and intrinsics (novel-sensor
        synthesis) -> numpy depth, raydrop, intensity [H, W]; rendered by
        this process alone, as the JAX package's ``render_pano``."""
        out = sweep.render_pano(
            self.eval_renderer(use_ema), pose, t, int(H), int(W),
            tuple(intrinsics_lidar), tuple(intrinsics_hoz_lidar),
            self._occ_kwargs(self.occ_grid_lidar, lidar=True))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def render_view(self, pose, t, H, W, intrinsics, use_ema=False) -> dict:
        """A camera view at any pose, time and intrinsics -> numpy rgb
        [H, W, 3], depth [H, W]."""
        out = sweep.render_view(self.eval_renderer(use_ema), pose, t, int(H),
                                int(W), intrinsics,
                                self._occ_kwargs(self.occ_grid_rgb))
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def render_lidar_frame(self, fi: int, use_ema=False) -> dict:
        """Training frame ``fi``'s LiDAR pano, full frame."""
        scene = self.scene
        return self.render_pano(scene.poses_lidar[fi], scene.times[fi],
                                scene.H_lidar, scene.W_lidar,
                                scene.intrinsics_lidar,
                                scene.intrinsics_hoz_lidar, use_ema)

    def render_camera_frame(self, fi: int, use_ema=False) -> dict:
        """Training frame ``fi``'s camera view, full frame."""
        scene = self.scene
        return self.render_view(scene.poses[fi], scene.times[fi], scene.H,
                                scene.W, scene.intrinsics, use_ema)

    # ------------------------------------------------------------------
    # refine stage (``nvsf_tpu/train/trainer.py:868-910``)
    # ------------------------------------------------------------------
    def refine(self, steps: int = 1000, lr: float = 1e-3, log_fn=print):
        """Render every training frame from the EMA field, train the U-Net
        raydrop refiner on the renders, and write the refine checkpoint.
        Returns the logged refine losses. Under a mesh the frames render
        sharded over the ranks, and the U-Net trains on rank 0 (cuDNN's
        algorithms are not bitwise deterministic, so ranks training it
        would drift apart), which broadcasts it; the other ranks return
        no losses."""
        scene = self.scene
        with self.timers.phase("refine render"):
            sw = sweep.render_lidar_sweep(
                self.ema_renderer, scene.poses_lidar, scene.times,
                scene.H_lidar, scene.W_lidar, scene.intrinsics_lidar,
                scene.intrinsics_hoz_lidar,
                occ_kwargs=self._occ_kwargs(self.occ_grid_lidar, lidar=True),
                mesh=self.mesh)
        x = np.stack([sw["raydrop"], sw["intensity"], sw["depth"]], axis=1)
        y = scene.images_lidar[:, None, :, :, 0]
        losses = []
        with self.timers.phase("refine unet"):
            if self.is_main:
                losses = refine_raydrop(self.unet, x, y, steps=steps, lr=lr,
                                        log_fn=log_fn)
            if self.mesh is not None:
                replicate(self.mesh, [*self.unet.parameters(),
                                      *self.unet.buffers()], "unet")
        self.unet_trained = True
        self.save_checkpoint(full=False, suffix="refine")
        return losses

    def refine_raydrop_pano(self, pred_raydrop, pred_intensity, pred_depth):
        """The U-Net's refined raydrop [H, W] of one rendered pano."""
        return apply_refinement(self.unet, pred_raydrop, pred_intensity,
                                pred_depth)

    # ------------------------------------------------------------------
    # checkpoints (``nvsf_tpu/train/trainer.py:924-964``)
    # ------------------------------------------------------------------
    def save_checkpoint(self, full=True, best=False,
                        suffix="") -> Optional[str]:
        """A checkpoint in the JAX package's layout (``bridge.py``);
        ``full`` adds the error maps and the Adam state. Under a mesh rank
        0 writes it and returns its path, the other ranks None, each once
        it is written."""
        path = None
        if self.is_main:
            path = ckpt.save_checkpoint(
                self.workspace, self.name, self.epoch,
                bridge.export_trainer_state(self, full), best=best,
                suffix=suffix)
            self.checkpoints_written.append(path)
        if self.mesh is not None:
            self.mesh.barrier()
        return path

    def load_checkpoint(self, which="latest",
                        prefer_refine: Optional[bool] = None) -> bool:
        """Restore params, EMA, optimizer, error maps, U-Net and occupancy
        grids from a checkpoint of either package; False when none
        resolves. ``prefer_refine`` (test and eval callers pass
        ``cfg.use_refine``) picks the refine checkpoint."""
        path = ckpt.resolve_checkpoint(self.workspace, self.name, which,
                                       prefer_refine=bool(prefer_refine))
        if path is None:
            return False
        payload = ckpt.load_checkpoint(path)
        self.unet_trained = False
        bridge.load_trainer_state(self, payload)
        return True
