"""The U-Net refine step captured as a CUDA graph, with the convolutions'
algorithms timed at their first call (``cudnn.benchmark``, under which
``nvsf_torch/train/refine.py::RefineSteps`` runs its graphed path's
warm-ups and capture) and with cuDNN's
heuristics (torch's default). Needs an NVIDIA GPU:

    python3 tools/ablate_refine_autotune.py

Each variant runs in a fresh process, as it is the first capture of a
process that differs: a ``RefineSteps`` of a seeded U-Net at the bench
scene's shape [15, 3, 66, 1030] (random inputs, f32 convolutions, the
shipped 1000-step schedule) takes its two eager steps and its capture,
then 5 replays and 5 eager steps of a copy are timed in turns (host clock
around synchronised steps, median). Prints one line per variant (the
graph's pool, the wall times), the card's name and power limit, and a
JSON summary last.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import nvsf_torch.train.refine as rf  # noqa: E402
from nvsf_torch.models.unet import UNet  # noqa: E402

VARIANTS = ("autotuned", "heuristics")
SHAPE = (15, 3, 66, 1030)


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def one(variant: str) -> dict:
    """The variant in this process -> its pool and times."""
    if variant == "heuristics":
        rf.autotuned_convolutions = contextlib.nullcontext
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    B, _, H, W = SHAPE
    x = torch.rand(SHAPE, generator=gen).to(dev)
    gt = (torch.rand((B, 1, H, W), generator=gen) > 0.4).float().to(dev)
    unet = UNet(3, 32, 1, generator=gen).to(dev).train()
    g = rf.RefineSteps(unet, x, gt, steps=1000, lr=1e-3)
    e = rf.RefineSteps(copy.deepcopy(unet), x, gt, steps=1000, lr=1e-3,
                       graphed=False)
    for i in range(3):
        g.step(i)
        e.step(i)
    walls = {"graphed": [], "eager": []}
    for i in range(3, 8):
        walls["graphed"].append(_wall_ms(lambda: g.step(i)))
        walls["eager"].append(_wall_ms(lambda: e.step(i)))
    pool = tuple(g.program.pool)
    gib = sum(s["total_size"] for s in torch.cuda.memory_snapshot()
              if tuple(s.get("segment_pool_id", ())) == pool) / 2**30
    return {"variant": variant, "pool_gib": gib,
            "capture_s": g.program.capture_s,
            **{f"{k}_ms": float(np.median(v)) for k, v in walls.items()}}


def main() -> int:
    if len(sys.argv) == 2:
        print(json.dumps(one(sys.argv[1])))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = []
    for variant in VARIANTS:
        run = subprocess.run([sys.executable, __file__, variant],
                             capture_output=True, text=True, check=True)
        r = json.loads(run.stdout.strip().splitlines()[-1])
        out.append(r)
        print(f"[{variant}] refine step {SHAPE}, f32: graphed "
              f"{r['graphed_ms']:.2f} ms, eager {r['eager_ms']:.2f} ms; "
              f"capture {r['capture_s']:.2f} s, pool {r['pool_gib']:.2f} "
              f"GiB ({smi})", flush=True)
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
