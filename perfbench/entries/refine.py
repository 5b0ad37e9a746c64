"""The U-Net ray-drop refiner's refine stage, as ``Trainer.refine`` runs it
after a scene's field is trained: ``refine_steps`` on the ``Trainer``'s own
U-Net (``run.tr.unet``) over every frame of the scene at once, at the
configuration's schedule (``refine``: steps, peak rate, the loss read on
the host every ``log_every``-th step), through ``RefineSteps.run``, the
loop ``refine_raydrop`` runs. A unit is the mix's ``steps_per_unit`` steps
of the schedule, replayed from the captured step, ending on a sync.

The input stands in for the EMA field's renders of the frames (their
values do not change the U-Net's work): the scene's own LiDAR panos
(ray drop, intensity, depth) plus the mix's seeded Gaussian ``noise``; the
target is the panos' ray drop, as ``Trainer.refine`` takes
``images_lidar[..., 0]``.

Set-up runs the mix's ``checked_steps`` steps: on the card the two eager
warm-ups, the capture and the first replay. Each is kept for the check:
the state before it (parameters, BatchNorm statistics, Adam's moments and
count), its U-Net output, loss and gradients, and the state after it.
``numbers`` compares them with ``reference/unet.py``'s steps from the same
states on the same draws, once ``Run.release`` has freed the program:

  - ``out_gap``: the mean absolute gap of the sigmoid output over the
    batch;
  - ``loss_gap``: the loss's relative gap;
  - ``grad_gap``: the worst parameter's gradient gap, the norm of the
    difference over the reference gradient's norm, floored at a millionth
    of the largest parameter's (a gradient within float32's rounding of
    zero);
  - ``bn_stat_gap``: the worst running mean or variance, the norm of the
    gap over the norm of the reference's change in the step;
  - ``change_gap_median``: the median parameter's gap between the
    program's parameters after the step and the reference's (its own
    step, from its own gradients), over the norm of the reference's
    update; an unchanged state reads 1;

each the widest over the checked steps. ``SIDES``: ``control``, the
reference with every convolution in bfloat16, below the configuration's
TF32; ``fault_align``, the reference upsampling with ``align_corners=True``.
"""

from __future__ import annotations

import gc
import math
import sys

import numpy as np
import torch

NUMBERS = ("out_gap", "loss_gap", "grad_gap", "bn_stat_gap",
           "change_gap_median")
SIDES = ("control", "fault_align")


def _unet_widths(unet) -> dict:
    return {"in_channels": unet.inc.shape[1], "channels": unet.inc.shape[0],
            "out_channels": unet.outc.conv.shape[0],
            "dropout": unet.down1.dropout, "num_heads": unet.attn.num_heads}


def _precision() -> dict:
    def kind(tf32):
        return "tf32" if tf32 else "float32"
    return {"conv": kind(torch.backends.cudnn.allow_tf32),
            "matmul": kind(torch.backends.cuda.matmul.allow_tf32)}


def inputs(run):
    """(x [F, 3, H, W], gt [F, 1, H, W]) on the card from the scene's
    panos and the seed."""
    panos = torch.as_tensor(run.scene["panos"], device=run.device)
    x = panos.permute(0, 3, 1, 2).contiguous()
    gen = torch.Generator(device=run.device).manual_seed(run.seeds.order)
    x += run.mix["noise"] * torch.randn(x.shape, generator=gen,
                                        device=run.device)
    return x, panos[:, None, :, :, 0].contiguous()


def _host(t):
    return t.detach().to("cpu", copy=True)


def _state(rs) -> dict:
    adam = {}
    for k, p in rs.unet.named_parameters():
        st = rs.opt.state.get(p)
        adam[k] = {"exp_avg": _host(st["exp_avg"]),
                   "exp_avg_sq": _host(st["exp_avg_sq"]),
                   "step": float(st["step"])} if st else None
    return {"params": {k: _host(p) for k, p in rs.unet.named_parameters()},
            "buffers": {k: _host(b) for k, b in rs.unet.named_buffers()},
            "adam": adam}


def setup(run):
    from nvsf_torch.train.refine import refine_steps
    u, r = run.cfg_file["unet"], run.cfg_file["refine"]
    got = _unet_widths(run.tr.unet)
    if got != {k: u[k] for k in got}:
        raise ValueError(f"the Trainer's U-Net is {got}; the configuration "
                         f"states {u}")
    prec = _precision()
    stated = {k: run.cfg_file["precision"][k] for k in prec}
    if prec != stated:
        raise ValueError(f"the refine step would run {prec}; the "
                         f"configuration states {stated}")
    x, gt = inputs(run)
    if x.shape[0] != r["batch"]:
        raise ValueError(f"Trainer.refine's batch is every frame, "
                         f"{x.shape[0]}; the configuration states "
                         f"{r['batch']}")
    rs = refine_steps(run.tr.unet, x, gt, steps=r["steps"], lr=r["lr"])
    n = run.mix["checked_steps"]
    if rs.program is not None and n <= rs.program.warmups:
        raise ValueError(f"{n} checked steps check no replay after the "
                         f"program's {rs.program.warmups} warm-ups")
    run.refine = rs
    print(f"refine: U-Net {list(x.shape)}, convolutions {prec['conv']}, "
          f"matrix products {prec['matmul']}, "
          f"{'graphed' if rs.program is not None else 'eager'}",
          file=sys.stderr)
    states, steps = [], []
    state = _state(rs)
    for k in range(n):
        states.append(state)
        loss, = rs.run(k, k + 1, log_every=1)
        state = _state(rs)
        steps.append({"out": _host(rs.out), "loss": loss,
                      "grads": {name: _host(p.grad) for name, p in
                                rs.unet.named_parameters()},
                      "params": state["params"],
                      "buffers": state["buffers"]})
    run.out["refine"] = {"x": _host(x), "gt": _host(gt), "states": states,
                         "steps": steps, "precision": prec}
    run.refine_next = n
    for _ in range(run.mix["warmup_units"]):
        unit(run)


def unit(run) -> int:
    rs = run.refine
    n, i = run.mix["steps_per_unit"], run.refine_next
    replays = rs.program.replays if rs.program is not None else 0
    losses = rs.run(i, i + n, log_every=run.cfg_file["refine"]["log_every"])
    run.sync()
    run.refine_next = i + n
    bad = 0 if all(math.isfinite(v) for v in losses) \
        and bool(torch.isfinite(rs.out).all()) else n
    if rs.program is not None:
        # a step that did not replay the captured step ran eagerly
        bad = max(bad, n - (rs.program.replays - replays))
    run.failed += bad
    return n


def measures(run):
    B, _, H, W = run.out["refine"]["x"].shape
    return {"train_rays_per_s": run.work["count"] * B * H * W
            / run.work["wall_s"]}


# ----------------------------------------------------------------------
# the check
# ----------------------------------------------------------------------

def _free(run):
    """The program's steps (the captured graph and its pool) dropped
    before the reference takes the card."""
    if getattr(run, "refine", None) is not None:
        run.refine = None
        gc.collect()
        if run.device.type == "cuda":
            torch.cuda.empty_cache()


def _computed(run, side: str):
    """The reference's checked steps (``side`` "reference") or a side's,
    from the program's states before each, on the host."""
    cache = run.__dict__.setdefault("refine_sides", {})
    if side not in cache:
        _free(run)
        from perfbench.reference import unet as ref
        o, dev = run.out["refine"], run.device

        def host(res):
            return {k: ({n: _host(t) for n, t in v.items()}
                        if isinstance(v, dict) else
                        _host(v) if torch.is_tensor(v) else v)
                    for k, v in res.items()}
        cache[side] = ref.checked_steps(
            o["states"], o["x"].to(dev), o["gt"].to(dev),
            run.cfg_file["unet"], run.cfg_file["refine"],
            ref.bf16_conv if side == "control" else ref.f32_conv,
            side == "fault_align", host)
        gc.collect()
    return cache[side]


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _out_gap(o, r, s):
    return float((o["out"].double() - r["out"].double()).abs().mean())


def _loss_gap(o, r, s):
    return abs(o["loss"] - r["loss"]) / max(abs(r["loss"]), 1e-30)


def _grad_gap(o, r, s):
    ref = {k: _norm(g) for k, g in r["grads"].items()}
    floor = max(1e-6 * max(ref.values()), 1e-30)
    return max(_norm(o["grads"][k] - g) / max(ref[k], floor)
               for k, g in r["grads"].items())


def _bn_stat_gap(o, r, s):
    return max(_norm(o["buffers"][k] - b)
               / max(_norm(b - s["buffers"][k]), 1e-30)
               for k, b in r["buffers"].items())


def _change_gap_median(o, r, s):
    return float(np.median([
        _norm(o["params"][k] - p) / max(_norm(p - s["params"][k]), 1e-30)
        for k, p in r["params"].items()]))


NUMS = {"out_gap": _out_gap, "loss_gap": _loss_gap, "grad_gap": _grad_gap,
        "bn_stat_gap": _bn_stat_gap,
        "change_gap_median": _change_gap_median}


def numbers(run, names, side="program"):
    if side != "program" and side not in SIDES:
        raise ValueError(f"{side!r} is not one of the entry's sides {SIDES}")
    ref = _computed(run, "reference")
    other = run.out["refine"]["steps"] if side == "program" \
        else _computed(run, side)
    states = run.out["refine"]["states"]
    return {k: max(NUMS[k](*a) for a in zip(other, ref, states))
            for k in names}
