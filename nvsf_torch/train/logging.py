"""Console + file logger, tensorboard scalars, sampling heatmaps and
parameter counts (counterpart of ``nvsf_tpu/train/logging.py``, which
rebuilds ``nvsf/nerf/utils.py:497-557,875-920`` and the tensorboardX
scalars of ``trainer.py:1364-1368,1793-1841``)."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from nvsf_torch.lib.tools import write_png


class Logger:
    """Console + append-file logger."""

    def __init__(self, workspace: Optional[str] = None,
                 name: str = "nvsf", quiet: bool = False):
        self.quiet = quiet
        self.fp = None
        if workspace:
            os.makedirs(workspace, exist_ok=True)
            self.path = os.path.join(workspace, f"log_{name}.txt")
            self.fp = open(self.path, "a")

    def log(self, *args):
        msg = " ".join(str(a) for a in args)
        stamp = time.strftime("%Y-%m-%d %H:%M:%S")
        if not self.quiet:
            print(msg, flush=True)
        if self.fp:
            self.fp.write(f"[{stamp}] {msg}\n")
            self.fp.flush()

    __call__ = log

    def close(self):
        if self.fp:
            self.fp.close()
            self.fp = None


class TensorboardWriter:
    """Thin tensorboardX wrapper, disabled without a ``workspace`` (on the
    ranks of a mesh but rank 0) or when tensorboardX is absent."""

    def __init__(self, workspace: Optional[str], name: str = "run"):
        self.writer = None
        if not workspace:
            return
        try:
            import tensorboardX
        except ImportError:
            pass
        else:
            self.writer = tensorboardX.SummaryWriter(
                os.path.join(workspace, name))

    def add_scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))

    def add_scalars_dict(self, prefix, values: dict, step):
        for k, v in values.items():
            try:
                self.add_scalar(f"{prefix}/{k}", float(v), step)
            except (TypeError, ValueError):
                pass  # vector-valued metrics are written by their meters

    def close(self):
        if self.writer is not None:
            self.writer.close()


def save_sampling_heatmap(error_map: np.ndarray, path: str) -> None:
    """A frame's sampling weights (its error map) as a PNG, square-rooted
    for visibility."""
    em = np.asarray(error_map, np.float64)
    em = em / max(em.max(), 1e-12)
    write_png(path, (np.sqrt(em) * 255).astype(np.uint8))


def count_parameters(params: Dict[str, torch.Tensor]) -> int:
    """Elements of ``{name: tensor}`` (``named_parameters``)."""
    return sum(int(p.numel()) for p in params.values())


def model_summary(params: Dict[str, torch.Tensor]) -> str:
    """Parameter counts by top-level module of ``{name: tensor}``."""
    groups = {}
    for k, p in params.items():
        groups.setdefault(k.split(".")[0], {})[k] = p
    lines = [f"  {k:20s} {count_parameters(g):>12,d}"
             for k, g in groups.items()]
    lines.append(f"  {'TOTAL':20s} {count_parameters(params):>12,d}")
    return "\n".join(lines)
