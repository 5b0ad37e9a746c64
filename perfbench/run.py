"""Run one cell of nvsf_torch's benchmark once, on the machine it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` names the cell's configuration (``perfbench/configs/``)
and traffic mix (``perfbench/traffic/``); its limits are
``perfbench/limits/<cell>.json``; the per-layer metrics are the readers in
``perfbench/metrics/``; a mix's entry other than ``train`` and
``render_lidar`` is the module ``perfbench/entries/<entry>.py``, with its
plain reference under ``perfbench/reference/``. The run makes the scene
and the initial weights on the card from the seed, builds the program's
``Trainer``, drives the mix's checked start (training), loads the
benchmark's settled state (render) or runs the entry module's set-up, and
warms up (set-up), then measures for
``--seconds`` (``--trace 0``: the end-to-end metrics) or traces a short
window under ``torch.profiler`` (``--trace 1``: the per-layer metrics), and
checks what the window produced against the plain float32 reference.

Its last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit);
the numbers compared are also the last lines on standard error. It exits
with 2 and prints no result without enough CUDA devices or without the
program, and with 3 if the process holds JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nvsf_tpu")


def set_environment(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds; libraries that could load JAX are
    told not to; one CPU thread for the host's thread pools, so that the
    run's own load on a shared host stays small. Call before torch and
    numpy are imported."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[k] = "1"


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def execute(cfg_file: dict, mix: dict, limits: dict, e2e: list,
            layers: list, seed: int, seconds: float, trace: bool, device,
            chips: int, t_start: float) -> dict:
    """One run: set-up, window, check; the result's object."""
    from perfbench import check, harness
    run = harness.Run(cfg_file, mix, seed, seconds, trace, device, t_start,
                      limits)
    run.setup()
    print("set-up stages (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in run.stages.items()), file=sys.stderr)
    run.window()
    run.release()
    correct, rows = check.check(run)
    metrics = harness.per_layer(run, layers) if trace \
        else harness.end_to_end(run, e2e)
    result = {"correct": bool(correct), "attempted": run.work["count"],
              "failed": run.failed, "metrics": metrics,
              "device": run.device_info(chips)}
    if trace:
        result["breakdown"] = harness.breakdown(run)
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    set_environment()
    sys.path.insert(0, str(ROOT))
    try:
        from perfbench import harness
    except ImportError as e:
        print(f"perfbench: cannot import the benchmark: {e}", file=sys.stderr)
        return 2
    man = harness.manifest()
    cell = harness.cell(man, a.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"perfbench: {a.workload} needs {cell['chips']} CUDA device(s);"
              f" torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import nvsf_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program nvsf_torch is missing: {e}",
              file=sys.stderr)
        return 2
    result = execute(
        harness.config_file(man, cell["config"]),
        harness.traffic_file(cell["traffic"]),
        harness.limits_file(a.workload),
        harness.cell_metrics(man, a.workload, "end_to_end"),
        harness.cell_metrics(man, a.workload, "per_layer"),
        a.seed, a.seconds, bool(a.trace), "cuda", int(cell["chips"]),
        T_START)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k} = {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
