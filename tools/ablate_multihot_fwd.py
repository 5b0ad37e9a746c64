"""The multihot forward (B3) as this checkout builds it against builds of
other kernel sources with the same C interface, on the inputs of one real
training step and one render slab, and on random inputs at their shapes.
Needs an NVIDIA GPU and nvcc:

    python3 tools/ablate_multihot_fwd.py [NAME=DIR ...]

Each DIR holds the ``*.cu`` sources (and headers) of one variant: the
parent commit's ``nvsf_torch/csrc`` unpacked with ``git archive`` into a
gitignored directory, say, or a copy of ``nvsf_torch/csrc`` with
``multihot.cu`` changed. Every build goes through the package's wrapper
(``multihot.multihot_fwd_cuda``), so the host's part is the same Python
for all and differs only in the C launcher.

Trains chip_smoke.py's joint LiDAR + camera configuration for one random
and one patch epoch, captures the forward inputs of one more step (the
tables, cols and ws of every B4 launch, as chip_smoke.py's "step" rows do)
and of one render slab of the same field (2,048 rays x 16 samples, as its
"eval" rows do), and adds random inputs at the step's LiDAR N and at the
render's 32,768 samples a segment (chip_smoke.py's phase 3 inputs). Checks
every build against the plain version in f64 on every input, then times
them in turns (this checkout, the others, the others in reverse, this
checkout): device time per call (``chip_smoke.device_ms``: a spin kernel
holds the stream while the host queues the calls) and the host's time per
call of the wrapper while the stream is held (its checks, the allocation
of ``out``, the ctypes call and the C launcher, not the kernel). Prints one
line per input, the card's name and power limit, and a JSON summary last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from nvsf_torch.ops import kernels  # noqa: E402
from nvsf_torch.ops import multihot as mh  # noqa: E402

HERE = "this"


def _inputs(tr):
    """(label, tables, cols, ws, W) of every captured forward of one step
    and one render slab of ``tr``, then of random inputs at the step's
    (LiDAR N) and the render's sample counts."""
    out = []
    for i, (tables, cols, ws, _g, W, _dw) in enumerate(
            cs.capture_step_inputs(tr)["multihot_bwd"]):
        out.append((f"step #{i} {tuple(cols.shape)} W={W}", tables, cols,
                    ws, W))
    for tables, cols, ws, W in cs.capture_eval_inputs(tr):
        out.append((f"eval slab {tuple(cols.shape)} W={W}", tables, cols, ws,
                    W))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for N in (2048 * 96, 2048 * 16):
        for Q, S, C, W, lerp in ((1, 6, 4, 4096, False),
                                 (3, 12, 2, 256, True)):
            tables, cols, ws, _ = cs._multihot_inputs(Q, S, C, W, 8, N, gen,
                                                      dev, lerp)
            out.append((f"random {tuple(cols.shape)} W={W}", tables, cols,
                        ws, W))
    return out


def _ok(tables, cols, ws, W):
    got = mh.multihot_fwd_cuda(tables, cols, ws, W)
    ref = mh.multihot_fwd_plain(tables.double(), cols, ws.double(), W)
    mags = mh.multihot_fwd_plain(tables.abs(), cols, ws.abs(), W)
    return cs.compare("multihot_fwd", got, ref, mags)[2]


def host_us(fn, reps: int = 50) -> float:
    """Host time per call of ``fn`` in us, while a spin kernel holds the
    stream so that no call waits for the device; raises if the spin ended
    before the last call was queued."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 25)       # ~20 ms at the H100's clock
    mark = torch.cuda.Event()
    mark.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    held = not mark.query()
    torch.cuda.synchronize()
    if not held:
        raise RuntimeError("the spin kernel ended before the calls were "
                           "queued")
    return dt / reps * 1e6


def main(argv):
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    trees = {HERE: kernels.CSRC}
    for arg in argv:
        name, _, path = arg.partition("=")
        if not path or name == HERE:
            print(f"expected NAME=DIR (NAME not {HERE!r}), got {arg!r}",
                  file=sys.stderr)
            return 2
        trees[name] = Path(path).resolve()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = {k: kernels.build_library(csrc=d) for k, d in trees.items()}
    others = [k for k in libs if k != HERE]
    order = [HERE, *others, *reversed(others), HERE]
    kernels._lib = libs[HERE]
    from nvsf_torch.train.trainer import Trainer
    spec, scene = cs.slice_scene()
    tr = Trainer(cs.joint_tuned_config(spec), scene, seed=0, device="cuda")
    for ep in (1, 2):
        tr.epoch = ep
        tr.train_one_epoch()
    results, bad = [], []
    for label, tables, cols, ws, W in _inputs(tr):
        def run():
            return mh.multihot_fwd_cuda(tables, cols, ws, W)

        dev_runs = {k: [] for k in libs}
        host_runs = {k: [] for k in libs}
        for k in order:
            kernels._lib = libs[k]
            if not dev_runs[k] and not _ok(tables, cols, ws, W):
                bad.append(f"{k} [{label}]")
            dev_runs[k].append(cs.device_ms(run))
            host_runs[k].append(host_us(run))
        kernels._lib = libs[HERE]
        dev = {k: sum(v) / len(v) for k, v in dev_runs.items()}
        host = {k: sum(v) / len(v) for k, v in host_runs.items()}
        results.append(dict(input=label, device_ms=dev, host_us=host,
                            device_runs=dev_runs, host_runs=host_runs))
        print(f"[ablate] B3 [{label}]: "
              + "; ".join(f"{k} device {dev[k]:.4f} ms, host {host[k]:.1f} us"
                          for k in libs), flush=True)
    print(smi)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "power": smi, "trees": {k: str(v)
                                               for k, v in trees.items()},
                      "results": results, "bad": bad}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
