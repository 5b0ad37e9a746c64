"""Whether a run's outputs are correct: the program's outputs against the
plain float32 reference (``reference/``), each number beside its limit
from the cell's ``limits/<cell>.json``.

The numbers a limit can name:
  - training (``TRAIN``), over the checked steps (``harness.Run.
    checked_start``: random steps, then patch steps, each mode up to its
    first replay of the captured step), at the first step (from the
    benchmark's weights) and at each replay (from the program's state
    before it), the widest over those steps:
      - ``parts_gap``: the step's loss terms (depth, intensity, ray drop,
        chamfer, flow, the patch step's gradient term, rgb): the gap of
        each over the larger of the reference's term and a thousandth of
        the reference's loss, the widest term;
      - ``errmap_fit_gap``: the step's frame's error maps (its per-ray
        losses, min-max normalised) at the cells one ray hit, the
        program's fitted to the reference's by a line (which takes out the
        normalisation by the batch's extreme rays): the mean absolute
        residual over the mean absolute deviation of the reference's, the
        wider of the two sensors;
      - ``grad_gap``: the step's gradient (the program's worked out from
        Adam's first moment before and after the step) by the worst
        parameter: the gap between the program's norm and the reference's,
        over the larger of the reference's norm of that parameter and of
        the median one;
      - ``change_gap_median`` / ``ema_gap_median``: the same of each
        parameter's change in the step / of its EMA's in the call, at the
        median parameter, over the parameters whose reference gradient in
        the step is at least a thousandth of the median one's (those below
        move by Adam's rounding alone);
  - render mixes (``FRAMES``), for a seeded sample of the window's
    frames, the mean absolute gap of the depth (meters), the ray drop and
    the intensity, the widest over the sampled frames (``depth_gap_m``,
    ``raydrop_gap``, ``intensity_gap``).
"""

from __future__ import annotations

import gc
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import model as refmodel
from perfbench.reference import step as refstep


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep
              ) -> Dict[str, float]:
    """Per parameter: |program's norm - reference's| over the larger of
    the reference's norm of that parameter and of the median one."""
    med = float(np.median([ref[k] for k in keep]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keep}


def moved(ref: dict, k: int) -> List[str]:
    """The parameters whose reference gradient at step ``k`` is at least a
    thousandth of the median parameter's."""
    g = ref["grads"][k]
    med = float(np.median(list(g.values())))
    return [n for n in g if g[n] >= 1e-3 * med]


def fit_gap(p: np.ndarray, r: np.ndarray) -> float:
    """Mean |p - (a + b r)| over the mean |r - mean r|, with a, b the
    least-squares line."""
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    A = np.stack([np.ones_like(r), r], axis=1)
    coef = np.linalg.lstsq(A, p, rcond=None)[0]
    dev = np.abs(r - r.mean()).mean()
    return float(np.abs(p - A @ coef).mean() / max(dev, 1e-30))


def errmap_gaps(prog: dict, ref: dict, stat) -> List[float]:
    """``stat(program, reference)`` of each recorded step's error map of
    each sensor at the cells one of the step's rays hit (the reference,
    or the reference put in the program's place, holds (map, hits))."""
    out = []
    for k, maps in ref["error_rows"].items():
        for br, (r, hits) in maps.items():
            p = prog["error_rows"][k][br]
            p = p[0] if isinstance(p, tuple) else p
            once = hits == 1
            if once.sum() > 2:
                out.append(stat(p[once], r[once]))
    return out


def _errmap_fit_gap(prog, ref):
    gaps = errmap_gaps(prog, ref, fit_gap)
    return max(gaps) if gaps else math.inf


def _parts_gap(prog, ref):
    return max(abs(prog["parts"][k].get(n, math.inf) - v)
               / max(abs(v), 1e-3 * abs(ref["losses"][k]))
               for k, terms in ref["parts"].items() for n, v in terms.items())


def _grad_gap(prog, ref):
    return max(max(leaf_gaps(prog["grads"][k], g, list(g)).values())
               for k, g in ref["grads"].items())


def _median_gap(key):
    def fn(prog, ref):
        return max(float(np.median(list(leaf_gaps(
            prog[key][k], r, moved(ref, k)).values())))
            for k, r in ref[key].items())
    return fn


TRAIN: Dict[str, Callable[[dict, dict], float]] = {
    "parts_gap": _parts_gap,
    "errmap_fit_gap": _errmap_fit_gap,
    "grad_gap": _grad_gap,
    "change_gap_median": _median_gap("change"),
    "ema_gap_median": _median_gap("ema"),
}


def _mean_gap(key, scale=1.0):
    def fn(prog, ref):
        p = np.asarray(prog[key], np.float64)
        return float(np.mean(np.abs(p - ref[key]))) / scale
    return fn


def frame_numbers(c: dict) -> Dict[str, Callable[[dict, dict], float]]:
    return {"depth_gap_m": _mean_gap("depth", c["scale"]),
            "raydrop_gap": _mean_gap("raydrop"),
            "intensity_gap": _mean_gap("intensity")}


def finite(v: float) -> float:
    return v if math.isfinite(v) else math.inf


def reference_train(run) -> dict:
    """The float32 reference over the checked steps (once a run): the
    first from the benchmark's weights, each replay from the program's
    state before it."""
    ref = getattr(run, "reference", None)
    if ref is None:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        c, s, t = run.c, run.seeds, run.out["train"]
        ref = refstep.train_steps(
            c, run.scene, refmodel.init_params(c, s.weights, run.device),
            t["steps"], s.trainer, run.device, states=run.states)
        run.reference = ref
        gc.collect()
    return ref


def reference_frames(run) -> List[Tuple[int, dict, dict]]:
    """(frame, the program's pano, the reference's) of a seeded sample of
    the window's frames; the reference renders them from the weights and
    the grid the benchmark made, with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c, s, dev = run.c, run.seeds, run.device
    cache = run.__dict__.setdefault("reference_frames", {})
    done = run.out["frames"]
    rng = np.random.default_rng(s.order + 1)
    pick = rng.choice(len(done), min(run.mix["checked_frames"], len(done)),
                      replace=False)
    out = []
    for i in sorted(pick):
        fi, pano = done[int(i)]
        if fi not in cache:
            params = refmodel.init_params(c, s.weights, dev)
            cache[fi] = refstep.render_lidar_frame(c, run.scene, params,
                                                   run.grid, fi, dev)
            del params
        out.append((fi, pano, cache[fi]))
    return out


def numbers(run, names, other_steps=None, other_frame=None
            ) -> Dict[str, float]:
    """The numbers ``names`` of the run's outputs against the reference;
    ``other_steps(weights)`` / ``other_frame(params, grid, fi)`` put
    something else in the program's place (the control, a planted
    fault)."""
    c, s, dev = run.c, run.seeds, run.device
    nums = {}
    if run.mix["entry"] == "train":
        ref = reference_train(run)
        prog = run.out["train"] if other_steps is None else other_steps(
            refmodel.init_params(c, s.weights, dev))
        run.compared = {"reference": ref, "other": prog}
        for k in names:
            nums[k] = finite(TRAIN[k](prog, ref))
    elif run.mix["entry"] == "render_lidar":
        fns = frame_numbers(c)
        for fi, pano, ref in reference_frames(run):
            if other_frame is not None:
                pano = other_frame(refmodel.init_params(c, s.weights, dev),
                                   run.grid, fi)
            for k in names:
                nums[k] = max(nums.get(k, 0.0), finite(fns[k](pano, ref)))
    else:
        nums = {k: finite(v)
                for k, v in run.module.numbers(run, names).items()}
    return nums


def check(run, other_steps=None, other_frame=None
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(correct, [(name, number, limit)]); with ``other_steps`` /
    ``other_frame`` of something put in the program's place."""
    limits = run.limits
    nums = numbers(run, list(limits), other_steps, other_frame)
    rows = [(k, float(nums[k]), float(lim)) for k, lim in limits.items()]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
