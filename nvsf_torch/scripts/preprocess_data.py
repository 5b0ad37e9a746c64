"""Preprocessing CLI (rebuilds ``nvsf/scripts/preprocess_data.py``; the
same argv as ``nvsf_tpu/scripts/preprocess_data.py``), raw KITTI-360 to
range views, transforms jsons and a training config:

  python -m nvsf_torch.scripts.preprocess_data --dataset kitti360 \
      --sequence_name 1908 --kitti_root data/kitti360/source_data \
      --data_root data/kitti360
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(__doc__)
    p.add_argument("--dataset", type=str, default="kitti360",
                   choices=["kitti360"])
    p.add_argument("--sequence_name", type=str, required=True)
    p.add_argument("--recording", type=str,
                   default="2013_05_28_drive_0000")
    p.add_argument("--kitti_root", type=str,
                   default="data/kitti360/source_data")
    p.add_argument("--data_root", type=str, default="data/kitti360")
    p.add_argument("--config_dir", type=str, default="configs")
    p.add_argument("--workspace", type=str, default="log/kitti360")
    args = p.parse_args(argv)

    from nvsf_torch.preprocess.kitti360 import preprocess_kitti360
    cfg_path = preprocess_kitti360(
        args.kitti_root, args.data_root, args.sequence_name,
        recording=args.recording, workspace=args.workspace,
        config_dir=args.config_dir)
    print(f"[preprocess] done; train with --config {cfg_path}")


if __name__ == "__main__":
    main()
