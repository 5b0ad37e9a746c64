"""CLI entry point of the port: training with evals, checkpoints and the
U-Net refine stage; test / test-eval with novel-sensor synthesis and mesh
export (counterpart of ``nvsf_tpu/scripts/main_nvsf.py``: the same flags,
config files, branches, artifacts and file names).

Usage:
  python -m nvsf_torch.scripts.main_nvsf --config configs/kitti360_1908.txt
  python -m nvsf_torch.scripts.main_nvsf --config ... --test_eval --use_refine
  python -m nvsf_torch.scripts.main_nvsf --config ... --test \\
      --delta_position 0 0 1 --V_lidar_ch 32      # novel sensor

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU. One
device only: a ``mesh_shape`` (data parallelism) is refused.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np
import torch

from nvsf_torch.config import load_config


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


def _test(cfg, device):
    """--test / --test_eval: load a checkpoint, score the test scene when
    it has ground truth and --test_eval asks, render and dump every frame,
    export the density mesh."""
    from nvsf_torch.render.export import export_mesh_density
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.test_mode import run_test
    from nvsf_torch.train.trainer import Trainer
    ns = _novel_sensor_dict(cfg)
    cfg_run = cfg.finalize(steps_per_epoch=1)
    test_scene = _load_scene(cfg_run, "test", novel_sensor=ns)
    # the trainer binds to the test scene for its shapes
    trainer = Trainer(cfg_run, test_scene, device=device)
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
    with timers.phase("test render"):
        run_test(trainer, test_scene, save_dir=results_dir,
                 name=cfg_run.name, use_refine=cfg_run.use_refine)
    with timers.phase("mesh"):
        export_mesh_density(
            trainer, bound_min=tuple(cfg_run.mesh_bound_min),
            bound_max=tuple(cfg_run.mesh_bound_max),
            xyz_res=tuple(cfg_run.mesh_xyz_res),
            threshold=cfg_run.density_thresh,
            out_path=os.path.join(results_dir, f"{cfg_run.name}_mesh.ply"))
    print(f"[time] stages:\n{timers.report()}", flush=True)
    return trainer


def _train(cfg, device):
    """Training with an eval and checkpoints every eval_interval epochs
    (best by combined CD), then the U-Net refine and the refined eval
    (none with ``refine_steps`` 0)."""
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.logging import (Logger, TensorboardWriter,
                                          model_summary,
                                          save_sampling_heatmap)
    from nvsf_torch.train.resilience import run_epochs_with_recovery
    from nvsf_torch.train.trainer import Trainer
    train_scene = _load_scene(cfg, "train")
    cfg_run = cfg.finalize(steps_per_epoch=len(train_scene))
    val_scene = _load_scene(cfg_run, "val")
    trainer = Trainer(cfg_run, train_scene, device=device)
    if cfg_run.ckpt != "scratch":
        trainer.load_checkpoint(cfg_run.ckpt)
    timers = trainer.timers

    log = Logger(cfg_run.workspace, cfg_run.name)
    tb = TensorboardWriter(cfg_run.workspace)
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
            if cfg_run.vis_training and trainer.error_map is not None:
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


def main(argv=None, device=None):
    """Run the CLI on ``argv`` on ``device`` (default: the card). Returns
    the trainer, whose ``timers`` hold the wall time of each stage."""
    cfg = load_config(argv)
    if cfg.mesh_shape:
        raise NotImplementedError(
            f"mesh_shape={cfg.mesh_shape!r}: data parallelism is not ported "
            "to nvsf_torch (ROADMAP.md A5, data parallel); it trains on "
            "one device")
    seed_everything(cfg.seed)
    os.makedirs(cfg.workspace, exist_ok=True)
    with open(os.path.join(cfg.workspace, f"args_{cfg.name}.txt"), "w") as f:
        for k, v in cfg.to_dict().items():
            f.write(f"{k} = {v}\n")
    if cfg.test or cfg.test_eval:
        return _test(cfg, device)
    return _train(cfg, device)


if __name__ == "__main__":
    main()
