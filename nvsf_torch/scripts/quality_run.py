"""The 8-frame synthetic quality protocol through the port (counterpart of
``tools/ablate_encoders.py::quality_run``; the protocol of
``VALIDATION.md``).

Trains one field on the 8-frame analytic synthetic scene (7 training
frames, LiDAR 32x96, camera 40x56) for ``--epochs`` epochs and scores the
held-out frame from the EMA parameters every ``--eval-every`` epochs and at
the last. The defaults are the arm whose seed noise is on record
(``VALIDATION.md:327-338``): the shape "flow-4x32" (hash 4x8, flow 4x32),
occupancy mode with 192 candidates and K 32 for both branches, eval K'
32, 60 epochs.

    python -m nvsf_torch.scripts.quality_run --seed 0
    python -m nvsf_torch.scripts.quality_run --seed 0 --device cpu \\
        --epochs 1 --eval-every 1

Prints the card's name and power limit first (``nvidia-smi``; "cpu" on the
CPU), then one JSON line per epoch (``epoch``, ``loss``, ``t``) and one per
eval, with the keys of the JAX tool (``CD``, ``F``, ``depth_RMSE``,
``raydrop_acc``, ``PSNR``, ``SSIM``). Runs on the card unless given
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from pathlib import Path

SHAPE_NAME = "flow-4x32"
SHAPE = dict(n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
             flow_n_features_per_level=32)

WORKSPACE = Path(__file__).resolve().parents[2] / "build" / "quality_run"


def card_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def quality_run(epochs=60, eval_every=20, seed=0, occ_k=32, eval_k=32,
                rays=1024, device=None, log=print):
    """Train and score one arm; returns the last eval record. ``eval_k``
    is the LiDAR and camera render-time K (None: the training ``occ_k``);
    ``rays`` the rays per branch and step (the protocol's 1024)."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.trainer import Trainer

    spec = SyntheticSceneSpec(num_frames=8, H_lidar=32, W_lidar=96, H=40,
                              W=56, max_depth=25.0, scale=1.0 / 26.0)
    train_scene = make_synthetic_scene(spec, split="train")
    val_scene = make_synthetic_scene(spec, split="val")
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True,
        num_frames=spec.num_frames, scale=spec.scale, bound=1.0,
        min_near_lidar=1.0 * spec.scale, lidar_max_depth=25.0 * spec.scale,
        min_near=1.0 * spec.scale, active_sensor=True,
        num_rays=rays, num_rays_lidar=rays, num_steps=192,
        num_steps_occ=occ_k,
        render_mode="occupancy", occ_grid_size=64,
        log2_hashmap_size=14, n_levels_plane=4,
        use_error_map=True, grad_loss=True,
        change_patch_size_lidar=[4, 4], change_patch_size_epoch=2,
        intrinsics_lidar=list(spec.intrinsics_lidar),
        intrinsics_hoz_lidar=list(spec.intrinsics_hoz_lidar),
        iters=epochs * len(train_scene), epochs=epochs,
        workspace=str(WORKSPACE / f"{SHAPE_NAME}_s{seed}"), **SHAPE))
    tr = Trainer(cfg, train_scene, seed=seed, device=device)
    swap = eval_k is not None and eval_k != occ_k
    t0 = time.time()
    rec = None
    for ep in range(1, epochs + 1):
        tr.epoch = ep
        stats = tr.train_one_epoch()
        log(json.dumps({"shape": SHAPE_NAME, "seed": seed, "epoch": ep,
                        "loss": round(stats.loss, 3),
                        "t": round(time.time() - t0, 1)}))
        if ep % eval_every == 0 or ep == epochs:
            # the eval renders read their K from cfg at call time
            train_cfg = tr.cfg
            if swap:
                tr.cfg = dataclasses.replace(tr.cfg, num_steps_occ=eval_k)
            try:
                res = evaluate(tr, val_scene, use_ema=True,
                               log_fn=lambda *a: None)
            finally:
                tr.cfg = train_cfg
            c = res["combined"]
            # point = [CD, F@0.05]; depth = [RMSE, MedAE, LPIPS, SSIM,
            # PSNR]; raydrop = [RMSE, Acc, F1]
            rec = {"shape": SHAPE_NAME, "seed": seed, "epoch": ep,
                   "train_loss": round(stats.loss, 2),
                   "CD": round(c["point"][0], 4),
                   "F": round(c["point"][1], 4),
                   "depth_RMSE": round(c["depth"][0], 4),
                   "raydrop_acc": round(c["raydrop"][1], 4),
                   "PSNR": round(c["rgb_psnr"], 2),
                   "SSIM": round(c["rgb_ssim"], 4),
                   "t": round(time.time() - t0, 1)}
            log(json.dumps(rec))
    return rec


def main(argv=None):
    from nvsf_torch.train.trainer import resolve_device
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--eval-every", type=int, default=20)
    ap.add_argument("--occ-K", type=int, default=32,
                    help="kept samples per ray of the 192 candidates")
    ap.add_argument("--eval-K", type=int, default=32,
                    help="render-time K of the held-out eval")
    ap.add_argument("--rays", type=int, default=1024,
                    help="rays per branch and step (a multiple of 16)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(card_line(dev), flush=True)
    return quality_run(args.epochs, args.eval_every, seed=args.seed,
                       occ_k=args.occ_K, eval_k=args.eval_K, rays=args.rays,
                       device=dev, log=lambda s: print(s, flush=True))


if __name__ == "__main__":
    main()
