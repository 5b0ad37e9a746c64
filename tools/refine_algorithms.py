"""The U-Net refine step at the refine stage's batch, every frame of a
64-frame scene ([64, 3, 66, 1030]), through ``refine_steps``: which
convolution kernels its eager steps and its replays run, its step times
and its memory. Needs an NVIDIA GPU:

    python3 tools/refine_algorithms.py [--batch 64]

A seeded U-Net at the published widths on random inputs takes the
program's two eager warm-ups (the first times cuDNN's algorithms,
``autotuned_convolutions``), its capture and its replays. The second eager
step and the second replay are traced, each alone, under
``torch.profiler``. Prints each traced step's kernels by device time, the
convolution kernels (names holding ``fprop``, ``dgrad`` or ``wgrad``) that
each ran and whether the two sets are one, the replays' wall time a step
(host clock around synchronised steps, median of 5), the peak memory, the
card's name and power limit, and a JSON summary last.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nvsf_torch.models.unet import UNet  # noqa: E402
from nvsf_torch.train.refine import refine_steps  # noqa: E402

CONV = ("fprop", "dgrad", "wgrad")


def traced_kernels(fn) -> dict:
    """{kernel name: [calls, device us]} of ``fn``'s device work."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = defaultdict(lambda: [0, 0.0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            out[e.name()][0] += 1
            out[e.name()][1] += e.duration_ns() / 1e3
    return dict(out)


def convs(kernels: dict) -> set:
    return {n for n in kernels if any(k in n.lower() for k in CONV)}


def show(title: str, kernels: dict, top: int = 40) -> None:
    total = sum(us for _, us in kernels.values())
    print(f"{title}: {len(kernels)} kernels, {total / 1e3:.3f} ms device")
    for n, (c, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]:
        print(f"  {us / 1e3:9.3f} ms {c:4d}x  {n[:150]}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=64)
    a = p.parse_args()
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}; "
          f"cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")
    gen = torch.Generator().manual_seed(0)
    shape = (a.batch, 3, 66, 1030)
    x = torch.rand(shape, generator=gen).to(dev)
    gt = (torch.rand((a.batch, 1, 66, 1030), generator=gen) > 0.4).float()
    unet = UNet(3, 32, 1, generator=gen).to(dev)
    rs = refine_steps(unet, x, gt.to(dev), steps=1000, lr=1e-3)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rs.run(0, 1)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    eager = traced_kernels(lambda: rs.run(1, 2))
    t0 = time.perf_counter()
    rs.run(2, 3)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    replay = traced_kernels(lambda: rs.run(3, 4))
    walls = []
    for i in range(4, 9):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rs.run(i, i + 1)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    show("eager step 1", eager)
    show("replay of step 3", replay)
    ce, cr = convs(eager), convs(replay)
    print("convolution kernels, eager:", sorted(ce))
    print("convolution kernels, replay:", sorted(cr))
    summary = {
        "card": smi, "batch": a.batch, "same_convolutions": ce == cr,
        "only_eager": sorted(ce - cr), "only_replay": sorted(cr - ce),
        "first_step_s": first_s, "capture_and_replay_s": capture_s,
        "capture_s": rs.program.capture_s, "replays": rs.program.replays,
        "replay_ms": walls, "replay_ms_median": statistics.median(walls),
        "eager_device_ms": sum(us for _, us in eager.values()) / 1e3,
        "replay_device_ms": sum(us for _, us in replay.values()) / 1e3,
        "memory_peak_bytes": torch.cuda.max_memory_allocated(),
        "memory_reserved_bytes": torch.cuda.memory_reserved()}
    print(json.dumps(summary))
    return 0 if ce == cr else 1


if __name__ == "__main__":
    sys.exit(main())
