"""What the warp aggregation of the scatter kernels B1 and B4 saves, on the
inputs of one real training step. Needs an NVIDIA GPU and nvcc:

    python3 tools/ablate_warp_aggregation.py

Builds the kernels twice: as the package builds them, and with
-DNVSF_NO_WARP_AGGREGATION, where each lane issues its own atomics
(nvsf_torch/csrc/warp_runs.cuh). Trains chip_smoke.py's joint LiDAR +
camera configuration for one random and one patch epoch, captures the
inputs of every B4 launch of one more step (as chip_smoke.py's "step"
rows do; the step's hash gradients run B1's rows stage inside the hash
lookup, ops/hash_lookup.py, so B1 has only phase 3's random inputs here),
checks both builds against the plain versions on each,
and times them in turns (aggregated, per-lane, per-lane, aggregated; CUDA
events, mean of 10 launches each). Also times both builds on phase 3's
random inputs of chip_smoke.py, where no neighbours repeat. Prints one line
per input, the card's name and power limit, and a JSON summary last.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from nvsf_torch.ops import kernels  # noqa: E402
from nvsf_torch.ops import multihot as mh  # noqa: E402
from nvsf_torch.ops import segsum  # noqa: E402

VARIANTS = {"aggregated": kernels.NVCC_FLAGS,
            "per-lane": kernels.NVCC_FLAGS + ("-DNVSF_NO_WARP_AGGREGATION",)}


def _inputs(tr):
    """(kernel, label, *wrapper arguments) for every captured B4 call of
    one step of ``tr``, then for phase 3's random B1 and B4 inputs."""
    out = []
    calls = cs.capture_step_inputs(tr)
    for i, (tables, cols, ws, g, W, need_dw) in enumerate(
            calls["multihot_bwd"]):
        out.append(("multihot_bwd", f"step #{i} {tuple(cols.shape)} W={W} "
                    f"need_dw={need_dw}", tables, cols, ws, g, W, need_dw))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, cols, vals, T in cs._segment_add_cases(gen, dev):
        out.append(("segment_add", f"random {name} M={vals.shape[1]} "
                    f"F={vals.shape[0]} T={T} bf16", cols, vals, T, "bf16"))
    for sh in (dict(Q=1, S=6, C=4, W=4096, need_dw=False, lerp=False),
               dict(Q=3, S=12, C=2, W=256, need_dw=True, lerp=True)):
        tables, cols, ws, g = cs._multihot_inputs(
            sh["Q"], sh["S"], sh["C"], sh["W"], 8, 2048 * 96, gen, dev,
            sh["lerp"])
        out.append(("multihot_bwd", f"random {tuple(cols.shape)} W={sh['W']}"
                    f" need_dw={sh['need_dw']}", tables, cols, ws, g,
                    sh["W"], sh["need_dw"]))
    return out


def _run(case):
    kind, _label, *args = case
    if kind == "segment_add":
        cols, vals, T, prec = args
        return lambda: segsum.segment_add_cuda(cols, vals, T, prec)
    tables, cols, ws, g, W, need_dw = args
    return lambda: mh.multihot_bwd_cuda(tables, cols, ws, g, W, need_dw)


def _check(case):
    kind, label, *args = case
    if kind == "segment_add":
        cols, vals, T, prec = args
        got = segsum.segment_add_cuda(cols, vals, T, prec)
        ref = segsum.segment_add_plain(cols, vals, T, prec)
        mags = segsum.segment_add_plain(cols, vals.abs(), T, "f32")
        return cs.compare(label, got, ref, mags)[2]
    tables, cols, ws, g, W, need_dw = args
    dt, dw = mh.multihot_bwd_cuda(tables, cols, ws, g, W, need_dw)
    # the plain version in f64, as chip_smoke.py's checks (its SUM_RTOL)
    rdt, rdw = mh.multihot_bwd_plain(tables.double(), cols, ws.double(),
                                     g.double(), W, need_dw)
    bdt, bdw = mh.multihot_bwd_plain(tables.abs(), cols, ws.abs(), g.abs(),
                                     W, need_dw)
    ok = cs.compare(label, dt, rdt, bdt)[2]
    return ok and (not need_dw or cs.compare(label, dw, rdw, bdw)[2])


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = {k: kernels.build_library(f) for k, f in VARIANTS.items()}
    kernels._lib = libs["aggregated"]
    from nvsf_torch.train.trainer import Trainer
    spec, scene = cs.slice_scene()
    tr = Trainer(cs.joint_tuned_config(spec), scene, seed=0, device="cuda")
    for ep in (1, 2):
        tr.epoch = ep
        tr.train_one_epoch()
    cases = _inputs(tr)
    results, bad = [], []
    for case in cases:
        fn = _run(case)
        times = {k: [] for k in libs}
        for k in ("aggregated", "per-lane", "per-lane", "aggregated"):
            kernels._lib = libs[k]
            if not times[k] and not _check(case):
                bad.append(f"{k} {case[0]} [{case[1]}]")
            times[k].append(cs.cuda_ms(fn))
        kernels._lib = libs["aggregated"]
        ms = {k: sum(v) / len(v) for k, v in times.items()}
        results.append(dict(kernel=case[0], input=case[1], **{
            f"{k}_ms": v for k, v in ms.items()}, runs=times))
        print(f"[ablate] {case[0]} [{case[1]}]: aggregated "
              f"{ms['aggregated']:.4f} ms, per-lane {ms['per-lane']:.4f} ms "
              f"(runs {times})", flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "power": smi, "results": results, "bad": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
