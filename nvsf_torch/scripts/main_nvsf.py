"""CLI entry point of the port: training with evals, checkpoints and the
U-Net refine stage; test / test-eval with novel-sensor synthesis and mesh
export (counterpart of ``nvsf_tpu/scripts/main_nvsf.py``: the same flags,
config files, branches, artifacts and file names).

Usage:
  python -m nvsf_torch.scripts.main_nvsf --config configs/kitti360_1908.txt
  python -m nvsf_torch.scripts.main_nvsf --config ... --test_eval --use_refine
  python -m nvsf_torch.scripts.main_nvsf --config ... --test \\
      --delta_position 0 0 1 --V_lidar_ch 32      # novel sensor
  python -m nvsf_torch.scripts.main_nvsf --config ... --mesh_shape 4

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU. A
``mesh_shape`` ("4", or "2x2": the axes fold into one data axis) trains,
evaluates and refines data parallel (``nvsf_torch.parallel.mesh``): that
many ranks, each a process started here, one to a card over NCCL, or on
the CPU over gloo with ``device="cpu"``. An empty ``mesh_shape`` uses every
card when there are several, as the JAX package uses every device, and
runs in this process on one card. A ``mesh_shape`` asking for more ranks
than there are cards raises (the JAX package takes the first devices).
"""

from __future__ import annotations

import os
import random
import time
from typing import Optional

import numpy as np
import torch

from nvsf_torch.config import load_config
from nvsf_torch.parallel.mesh import mesh_from_spec, spawn


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def _load_scene(cfg, split, novel_sensor=None):
    """The scene of a split. The synthetic scene takes the novel-sensor
    overrides too (``nvsf_tpu``'s CLI ignores them there)."""
    if cfg.dataloader == "synthetic":
        from nvsf_torch.data.dataset import apply_novel_sensor
        from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                               make_synthetic_scene)
        spec = SyntheticSceneSpec(num_frames=cfg.num_frames, scale=cfg.scale)
        scene = make_synthetic_scene(spec, split=split)
        if novel_sensor:
            scene = apply_novel_sensor(scene, novel_sensor, scale=cfg.scale)
        return scene
    from nvsf_torch.data.kitti360 import load_kitti360_scene
    return load_kitti360_scene(cfg, split, novel_sensor=novel_sensor)


def _novel_sensor_dict(cfg):
    ns = {
        "delta_position": cfg.delta_position,
        "delta_orientation": cfg.delta_orientation,
        "H_lidar_new": cfg.V_lidar_ch,
        "W_lidar_new": cfg.H_lidar_ch,
        "intrinsics_lidar_new": cfg.intrinsics_lidar_new,
        "intrinsics_hoz_lidar_new": cfg.intrinsics_hoz_lidar_new,
        "delta_pos_camera": cfg.delta_pos_camera,
        "delta_orient_camera": cfg.delta_orient_camera,
        "H_new": cfg.H_new, "W_new": cfg.W_new,
    }
    changed = (any(np.any(np.asarray(v)) for v in (
        cfg.delta_position, cfg.delta_orientation, cfg.delta_pos_camera,
        cfg.delta_orient_camera, cfg.intrinsics_lidar_new,
        cfg.intrinsics_hoz_lidar_new))
        or cfg.V_lidar_ch or cfg.H_lidar_ch or cfg.H_new or cfg.W_new)
    return ns if changed else None


def _test(cfg, device, mesh=None):
    """--test / --test_eval: load a checkpoint, score the test scene when
    it has ground truth and --test_eval asks, render and dump every frame,
    export the density mesh. Under a mesh the score is sharded and rank 0
    alone renders the test frames and the mesh, as the JAX package renders
    them unsharded."""
    from nvsf_torch.render.export import export_mesh_density
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.test_mode import run_test
    from nvsf_torch.train.trainer import Trainer
    ns = _novel_sensor_dict(cfg)
    cfg_run = cfg.finalize(steps_per_epoch=1)
    test_scene = _load_scene(cfg_run, "test", novel_sensor=ns)
    # the trainer binds to the test scene for its shapes
    trainer = Trainer(cfg_run, test_scene, device=device, mesh=mesh)
    if not trainer.load_checkpoint(cfg_run.ckpt,
                                   prefer_refine=cfg_run.use_refine):
        raise FileNotFoundError(
            f"no checkpoint '{cfg_run.ckpt}' in {cfg_run.workspace}")
    results_dir = os.path.join(cfg_run.workspace, "results")
    timers = trainer.timers
    if test_scene.has_gt and cfg_run.test_eval:
        with timers.phase("test eval"):
            evaluate(trainer, test_scene, use_refine=cfg_run.use_refine,
                     save_dir=results_dir, name=cfg_run.name,
                     write_outputs=True)
    if not trainer.is_main:
        return trainer
    with timers.phase("test render"):
        run_test(trainer, test_scene, save_dir=results_dir,
                 name=cfg_run.name, use_refine=cfg_run.use_refine)
    export_mesh_density(
        trainer, bound_min=tuple(cfg_run.mesh_bound_min),
        bound_max=tuple(cfg_run.mesh_bound_max),
        xyz_res=tuple(cfg_run.mesh_xyz_res),
        threshold=cfg_run.density_thresh,
        out_path=os.path.join(results_dir, f"{cfg_run.name}_mesh.ply"))
    print(f"[time] stages:\n{timers.report()}", flush=True)
    return trainer


def _train(cfg, device, mesh=None):
    """Training with an eval and checkpoints every eval_interval epochs
    (best by combined CD), then the U-Net refine and the refined eval
    (none with ``refine_steps`` 0). Under a mesh rank 0 alone writes the
    log, the tensorboard scalars and the sampling heatmaps."""
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.logging import (Logger, TensorboardWriter,
                                          model_summary,
                                          save_sampling_heatmap)
    from nvsf_torch.train.resilience import run_epochs_with_recovery
    from nvsf_torch.train.trainer import Trainer
    train_scene = _load_scene(cfg, "train")
    cfg_run = cfg.finalize(steps_per_epoch=len(train_scene))
    val_scene = _load_scene(cfg_run, "val")
    trainer = Trainer(cfg_run, train_scene, device=device, mesh=mesh)
    if cfg_run.ckpt != "scratch":
        trainer.load_checkpoint(cfg_run.ckpt)
    timers = trainer.timers

    main_rank = trainer.is_main
    log = Logger(cfg_run.workspace if main_rank else None, cfg_run.name,
                 quiet=not main_rank)
    tb = TensorboardWriter(cfg_run.workspace if main_rank else None)
    log(f"[INFO] model parameters:\n"
        f"{model_summary(dict(trainer.field.named_parameters()))}")
    t0 = time.time()

    def on_epoch(ep, stats):
        tb.add_scalar("train/loss", stats.loss, ep)
        tb.add_scalars_dict("train", stats.parts, ep)
        if ep % cfg_run.eval_interval == 0 or ep == cfg_run.epochs:
            trainer.save_checkpoint(full=True)
            log(f"[epoch {ep}] loss={stats.loss:.5f} "
                f"({(time.time() - t0) / 60:.1f} min) parts="
                + " ".join(f"{k}={v:.4g}" for k, v in stats.parts.items()
                           if k != "loss"))
            if (cfg_run.vis_training and trainer.error_map is not None
                    and main_rank):
                save_sampling_heatmap(
                    trainer.error_map[len(train_scene) // 2].cpu().numpy(),
                    os.path.join(cfg_run.workspace, "validation",
                                 f"{cfg_run.name}_sampling_lidar_{ep}.png"))
            with timers.phase(f"eval ep{ep:04d}"):
                results = evaluate(
                    trainer, val_scene, use_refine=False,
                    save_dir=os.path.join(cfg_run.workspace, "validation"),
                    name=f"{cfg_run.name}_ep{ep:04d}", log_fn=log)
            for cat, r in results.items():
                tb.add_scalars_dict(f"eval_{cat}", {
                    k: (v[0] if isinstance(v, list) else v)
                    for k, v in r.items()}, ep)
            # the best checkpoint by the combined chamfer distance
            # (``trainer.py:1786-1791``, ``utils.py:650-676``)
            cd = results.get("combined", {}).get("point", [float("inf")])
            cd = cd[0] if isinstance(cd, list) else cd
            trainer.stats["results"].append(cd)
            best = trainer.stats.get("best_result")
            if cd == cd and (best is None or cd < best):
                trainer.stats["best_result"] = cd
                trainer.save_checkpoint(full=False, best=True)
                log(f"[epoch {ep}] new best CD {cd:.5f} -> best checkpoint")

    run_epochs_with_recovery(trainer, trainer.epoch + 1, cfg_run.epochs,
                             on_epoch, log_fn=log)
    # the refine stage and the refined eval (``trainer.py:1092-1096``);
    # refine_steps 0 skips both (the JAX CLI renders every training frame
    # and trains the U-Net for no step)
    if cfg_run.enable_lidar and cfg_run.refine_steps > 0:
        trainer.refine(steps=cfg_run.refine_steps, log_fn=log)
        with timers.phase("refined eval"):
            evaluate(trainer, val_scene, use_refine=True,
                     save_dir=os.path.join(cfg_run.workspace, "validation"),
                     name=f"{cfg_run.name}_ep{trainer.epoch:04d}_refined",
                     log_fn=log)
    log(f"[time] stages:\n{timers.report()}")
    log(f"==> Training finished in {(time.time() - t0) / 60:.2f} minutes")
    tb.close()
    log.close()
    return trainer


def _run(cfg, device, mesh=None):
    if cfg.test or cfg.test_eval:
        return _test(cfg, device, mesh)
    return _train(cfg, device, mesh)


def _run_rank(mesh, cfg):
    """One rank of a data-parallel run -> what the caller of ``main``
    gets of it: epoch and step, stage wall times (totals, and the last of
    each stage), the kernel launches and collectives of this rank, the
    checkpoints it wrote."""
    from nvsf_torch.ops import kernels
    seed_everything(cfg.seed)
    tr = _run(cfg, None, mesh)
    return {"rank": mesh.rank, "epoch": tr.epoch,
            "global_step": tr.global_step, "has_unet": tr.has_unet,
            "timers": dict(tr.timers.totals),
            "last_timers": dict(tr.timers.last),
            "launches": kernels.launch_counts(),
            "collectives": mesh.collectives,
            "checkpoints": tr.checkpoints_written}


def mesh_size(spec: str, cards: Optional[int]) -> int:
    """Ranks of the run's mesh, 0 for none (this process alone), with
    ``cards`` cards visible (None: the ranks run on the CPU)."""
    if not spec:
        return cards if cards and cards > 1 else 0
    n = mesh_from_spec(spec)
    if cards is not None and n > cards:
        raise ValueError(f"mesh_shape={spec!r} asks for {n} ranks, one to a "
                         f"card, and {cards} cards are visible")
    return n


def main(argv=None, device=None):
    """Run the CLI on ``argv`` on ``device`` (default: the card). Returns
    the trainer, whose ``timers`` hold the wall time of each stage; under
    a mesh, each rank's summary (``_run_rank``) in rank order."""
    cfg = load_config(argv)
    on_cpu = torch.device("cuda" if device is None else device).type == "cpu"
    world = mesh_size(cfg.mesh_shape,
                      None if on_cpu else torch.cuda.device_count())
    seed_everything(cfg.seed)
    os.makedirs(cfg.workspace, exist_ok=True)
    with open(os.path.join(cfg.workspace, f"args_{cfg.name}.txt"), "w") as f:
        for k, v in cfg.to_dict().items():
            f.write(f"{k} = {v}\n")
    if world:
        return spawn(_run_rank, world, (cfg,),
                     device="cpu" if on_cpu else "cuda")
    return _run(cfg, device)


if __name__ == "__main__":
    main()
