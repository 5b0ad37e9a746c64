"""Readings for the limits of ``check.py``, on the card at the cell's own
size: on each seed one run of the cell's set-up and a short window, then
the numbers of

  - ``program``: the program's outputs against the float32 reference (the
    lower readings);
  - ``control``: the reference in scaled float8 matrix products put in the
    program's place (the precision below the configuration's bf16);
  - ``fault_half``: the reference with half of each batch's rays left out
    and the per-ray losses of the rest counted double (the mean over the
    rest), in the program's place (training mixes);

with ``--f32 1`` the program built in float32 (``fp16`` off), a second
witness of what the program computes. Besides the numbers a limit can
name (``check.TRAIN``, ``check.frame_numbers``) it reads those below
(``EXTRA``), which no limit holds. One JSON line per seed and side, with
every parameter's norms, is appended to ``--out``.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \\
        --sides program,control,fault_half --out readings.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _mean_gap(p, r):
    return float(np.abs(p - r).mean() / max(r.mean(), 1e-30))


def _median_fit_gap(p, r):
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    A = np.stack([np.ones_like(r), r], axis=1)
    coef = np.linalg.lstsq(A, p, rcond=None)[0]
    return float(np.median(np.abs(p - A @ coef))
                 / max(np.median(np.abs(r - np.median(r))), 1e-30))


def _per_step(stat):
    """``stat`` of each recorded step's maps: {"<step>.<sensor>": v}."""
    def fn(prog, ref):
        out = {}
        for k, maps in ref["error_rows"].items():
            for br, (r, hits) in maps.items():
                p = prog["error_rows"][k][br]
                p = p[0] if isinstance(p, tuple) else p
                once = hits == 1
                if once.sum() > 2:
                    out[f"{k}.{br}"] = stat(p[once], r[once])
        return out if out else {"none": math.inf}
    return fn


def _extra():
    from perfbench import check
    return {
        "loss_gap": lambda p, r: max(_rel(p["losses"][s], v)
                                     for s, v in r["losses"].items()),
        "errmap_gap": lambda p, r: max(check.errmap_gaps(p, r, _mean_gap)),
        "errmap_fit_gap_median": lambda p, r: max(
            check.errmap_gaps(p, r, _median_fit_gap)),
        "errmap_fit_by_step": _per_step(check.fit_gap),
        "grad_gap_median": lambda p, r: max(
            float(np.median(list(check.leaf_gaps(p["grads"][k], g,
                                                 list(g)).values())))
            for k, g in r["grads"].items()),
        "change_gap": lambda p, r: max(max(check.leaf_gaps(
            p["change"][k], c, check.moved(r, k)).values())
            for k, c in r["change"].items()),
        "ema_gap": lambda p, r: max(max(check.leaf_gaps(
            p["ema"][k], e, check.moved(r, k)).values())
            for k, e in r["ema"].items()),
        "by_step": _by_step,
    }


def _by_step(p, r):
    """Each computed step's numbers of ``check.TRAIN``: {"<step>.<name>"}."""
    from perfbench import check
    out = {}
    for k in r["grads"]:
        one = {key: {k: r[key][k]} for key in ("grads", "change", "ema",
                                                "error_rows", "parts",
                                                "losses")}
        for name, fn in check.TRAIN.items():
            out[f"{k}.{name}"] = fn(p, one)
    return out


EXTRA = _extra


def _frame_extra(c):
    """Depth numbers no limit holds, each the widest over the frames."""
    def rel(p, r):
        d = np.asarray(p["depth"], np.float64)
        return float(np.abs(d - r["depth"]).mean()
                     / max(np.abs(r["depth"]).mean(), 1e-30))

    def fit(p, r):
        from perfbench import check
        return check.fit_gap(np.asarray(p["depth"]).reshape(-1),
                             np.asarray(r["depth"]).reshape(-1))
    return {"depth_rel_gap": rel, "depth_fit_gap": fit}


@contextlib.contextmanager
def half_batch(c: dict):
    """Half of each branch's rays left out of the step and the per-ray
    loss terms of the rest counted double (the mean over the rest)."""
    from perfbench.reference import model as M
    orig = dict(M.CRIT)
    rays = c["num_rays"], c["num_rays_lidar"]
    M.CRIT.update({k: (lambda p, g, fn=fn: 2.0 * fn(p, g))
                   for k, fn in orig.items()})
    c["num_rays"], c["num_rays_lidar"] = rays[0] // 2, rays[1] // 2
    try:
        yield
    finally:
        M.CRIT.update(orig)
        c["num_rays"], c["num_rays_lidar"] = rays


def others(run, side: str):
    """(other_steps, other_frame) for ``check.numbers``: what ``side``
    puts in the program's place (None, None for the program itself)."""
    from perfbench.reference import model as M
    from perfbench.reference import step as S
    c, s, dev = run.c, run.seeds, run.device
    t = run.out.get("train", {})
    if side == "program":
        return None, None
    if side == "control":
        return (lambda w: S.train_steps(c, run.scene, w, t["steps"],
                                        s.trainer, dev, M.fp8_mm,
                                        states=run.states),
                lambda p, g, fi: S.render_lidar_frame(c, run.scene, p, g, fi,
                                                      dev, M.fp8_mm))
    if side == "fault_half":
        def steps(w):
            c_half = dict(c)
            with half_batch(c_half):
                return S.train_steps(c_half, run.scene, w, t["steps"],
                                     s.trainer, dev, states=run.states)
        return steps, None
    raise ValueError(side)


def readings(run, side: str) -> dict:
    from perfbench import check
    t0 = time.perf_counter()
    steps, frame = (None, None) if run.module else others(run, side)
    if run.mix["entry"] == "train":
        nums = check.numbers(run, list(check.TRAIN), steps)
        prog, ref = run.compared["other"], run.compared["reference"]
        for k, fn in EXTRA().items():
            nums[k] = fn(prog, ref)
        compared = {k: {n: v for n, v in d.items() if n != "error_rows"}
                    for k, d in run.compared.items()}
    elif run.mix["entry"] == "render_lidar":
        fns = {**check.frame_numbers(run.c), **_frame_extra(run.c)}
        nums, per_frame = {}, {}
        for fi, pano, ref in check.reference_frames(run):
            if frame is not None:
                from perfbench.reference import model as M
                pano = frame(M.init_params(run.c, run.seeds.weights,
                                           run.device), run.grid, fi)
            per_frame[fi] = {k: fn(pano, ref) for k, fn in fns.items()}
            for k, v in per_frame[fi].items():
                nums[k] = max(nums.get(k, 0.0), v)
        compared = {"frames": per_frame}
    else:
        if side != "program" and side not in run.module.SIDES:
            raise ValueError(f"{side!r} is not one of the entry's sides "
                             f"{run.module.SIDES}")
        nums = run.module.numbers(run, list(run.module.NUMBERS), side)
        compared = {}
    return {"side": side, "numbers": nums,
            "seconds": time.perf_counter() - t0, "compared": compared}


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--sides", default="program,control")
    p.add_argument("--f32", type=int, default=0)
    p.add_argument("--others", type=int, default=1 << 30,
                   help="the sides other than program on the first N seeds "
                        "only")
    p.add_argument("--checked-frames", type=int, default=0,
                   help="compare this many of the window's frames")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench import harness, run as runmod
    runmod.set_environment()
    man = harness.manifest()
    cell = harness.cell(man, a.workload)
    cfg = harness.config_file(man, cell["config"])
    if a.f32:
        cfg["nvsf"]["fp16"] = False
    mix = harness.traffic_file(cell["traffic"])
    if a.checked_frames:
        mix["checked_frames"] = a.checked_frames
    for i, seed in enumerate(int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.Run(cfg, mix, seed, a.seconds, False, a.device, t0)
        run.setup()
        run.window()
        run.release()
        for side in a.sides.split(","):
            if side != "program" and i >= a.others:
                continue
            r = readings(run, side)
            r.update(workload=a.workload, seed=seed, f32=a.f32,
                     setup_s=run.setup_s, window=run.work)
            with open(a.out, "a") as f:
                f.write(json.dumps(r, default=float) + "\n")
            print(json.dumps({k: r[k] for k in ("side", "seed", "numbers",
                                                 "seconds")}, default=float),
                  flush=True)
        del run
    return 0


if __name__ == "__main__":
    sys.exit(main())
