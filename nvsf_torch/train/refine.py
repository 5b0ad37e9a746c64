"""Ray-drop refinement stage (counterpart of ``nvsf_tpu/train/refine.py``,
which rebuilds ``nvsf/nerf/trainer.py:905-1017``): the trained field's
renders of the training frames go through the U-Net alone, trained with
Adam under a OneCycle schedule, random-box masking of its inputs and a
BCE loss.

As in the reference implementation, the BCE-with-logits loss is taken of
the U-Net's *sigmoid* output. On the card each step replays the step
captured as a CUDA graph; on the CPU it runs eagerly, and there the random
draws of each step (the box mask and the U-Net's dropouts) can be injected
through ``draws``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch

from nvsf_torch.models.unet import UNet
from nvsf_torch.train.graphs import Program
from nvsf_torch.train.losses import bce_with_logits
from nvsf_torch.train.profiler import span


def onecycle_lr(max_lr: float, total_steps: int, pct_start: float = 0.3,
                div_factor: float = 25.0, final_div_factor: float = 1e4):
    """torch's OneCycleLR with cosine annealing, as a function of the
    step."""
    init_lr = max_lr / div_factor
    min_lr = init_lr / final_div_factor
    up = int(pct_start * total_steps)

    def sched(step: int) -> float:
        step = min(step, total_steps - 1)
        if step < up:
            return init_lr + (max_lr - init_lr) * 0.5 * (
                1 - math.cos(math.pi * min(step / max(up, 1), 1.0)))
        t = min(max((step - up) / max(total_steps - up, 1), 0.0), 1.0)
        return min_lr + (max_lr - min_lr) * 0.5 * (1 + math.cos(math.pi * t))

    return sched


def random_box_mask(shape, box_num_max=32, frac=0.1, generator=None,
                    draws: Optional[dict] = None, device=None):
    """A mask of ones with up to ``box_num_max`` random boxes zeroed: all
    boxes are drawn and a random count of them is applied. ``draws``
    replaces the draws: ``n_active`` (scalar) and ``ys``, ``xs``, ``sy``,
    ``sx`` ([box_num_max] each)."""
    B, C, H, W = shape
    by = max(int(frac * H), 2)
    bx = max(int(frac * W), 2)
    if draws is None:
        def randint(lo, hi, n=()):
            return torch.randint(lo, hi, n, generator=generator,
                                 device=device)
        draws = {"n_active": randint(0, box_num_max),
                 "ys": randint(0, H - by, (box_num_max,)),
                 "xs": randint(0, W - bx, (box_num_max,)),
                 "sy": randint(1, by, (box_num_max,)),
                 "sx": randint(1, bx, (box_num_max,))}
    d = {k: torch.as_tensor(v if torch.is_tensor(v) else np.array(v),
                            device=device).long()
         for k, v in draws.items()}
    yy = torch.arange(H, device=device)[None, :, None]
    xx = torch.arange(W, device=device)[None, None, :]

    def col(k):
        return d[k][:, None, None]

    inside = ((yy >= col("ys")) & (yy < col("ys") + col("sy"))
              & (xx >= col("xs")) & (xx < col("xs") + col("sx")))
    active = torch.arange(box_num_max, device=device) < d["n_active"]
    boxed = (inside & active[:, None, None]).any(dim=0)
    return (~boxed).to(torch.float32).expand(shape)


@contextlib.contextmanager
def autotuned_convolutions():
    """cuDNN picks each convolution's algorithm by timing its candidates at
    the first call of each shape (``cudnn.benchmark``), as XLA autotunes
    the convolutions of a compiled program; torch keeps the choice for the
    process, so later eager steps of the shape run it too. The graphed
    refine step's warm-ups and capture run under it: with cuDNN's
    heuristics a capture of the refine step sometimes chose other
    algorithms than its eager steps, one of them cuDNN's FFT convolution,
    with 32 GiB more in the graph's pool: 137.85 ms a replay at [15, 3, 66,
    1030] against 74.47 autotuned (NVIDIA H100 80GB HBM3, 700 W;
    ``tools/ablate_refine_autotune.py``)."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


class RefineSteps:
    """The refine stage's steps: the JAX package's ``step_fn``
    (``nvsf_tpu/train/refine.py:76-92``) on ``unet`` in training mode, from
    rendered (raydrop, intensity, depth) ``x_full`` [B, 3, H, W] to the GT
    raydrop ``gt`` [B, 1, H, W]. Adam with optax's ``scale_by_adam``
    defaults (0.9, 0.999, eps 1e-8 outside the square root) at the OneCycle
    rate of each step, held in a device tensor that ``step`` fills in place
    (``scale_by_schedule``); capturable on the card, where torch keeps its
    step count on the device too (torch refuses a capturable Adam on the
    CPU). The box masks and the U-Net's dropouts draw from ``generator``.

    On the card (``graphed`` None or True) each step replays the step
    captured as a CUDA graph (``train/graphs.py``) after two eager steps,
    the second under ``set_sync_debug_mode("error")``: all three are steps
    of the stage, and the generator is registered with the graph. The
    warm-ups and the capture time the convolutions' algorithms
    (``autotuned_convolutions``); the replays run what they chose. The
    eager steps' cached memory goes back to the card before the capture.
    ``graphed=False`` steps eagerly, the check the graph is held to; draws
    injected into a step (``draws``) exist on that path only.

    ``run(start, stop)`` takes a slice of the schedule, the stage's loop
    (``refine_raydrop``); ``out`` holds the last step's U-Net output (on
    the card, the graph's buffer, which the next replay overwrites)."""

    def __init__(self, unet: UNet, x_full: torch.Tensor, gt: torch.Tensor,
                 *, steps: int, lr: float, graphed: Optional[bool] = None):
        dev = x_full.device
        self.unet, self.x_full, self.gt = unet, x_full, gt
        self.sched = onecycle_lr(lr, steps)
        self.opt = torch.optim.Adam(
            unet.parameters(),
            lr=torch.tensor(self.sched(0), dtype=torch.float32, device=dev),
            betas=(0.9, 0.999), eps=1e-8, capturable=dev.type == "cuda")
        self.generator = torch.Generator(device=dev).manual_seed(0)
        if graphed is None:
            graphed = dev.type == "cuda"
        self.program = None
        if graphed:
            self.program = Program(self.body, dev, warmups=2,
                                   generators=[self.generator],
                                   held=self.state_tensors)

    @property
    def lr(self) -> torch.Tensor:
        """The rate the next step reads."""
        return self.opt.param_groups[0]["lr"]

    def state_tensors(self):
        """What a captured step reads and writes at fixed addresses."""
        out = [self.lr]
        for p in self.unet.parameters():
            out += [p, p.grad, *self.opt.state.get(p, {}).values()]
        return out + list(self.unet.buffers())

    def body(self, draws: Optional[dict] = None) -> torch.Tensor:
        """One step's device work; returns its loss (a device scalar) and
        keeps the U-Net's output in ``out``. Its spans: ``loss`` (the box
        mask; the BCE, forward and backward), ``optim`` (zero-grad; Adam),
        the U-Net's own and ``backward`` around the backward."""
        d = draws or {}
        dev = self.x_full.device
        with span("loss", dev):
            x = self.x_full * random_box_mask(
                self.x_full.shape, generator=self.generator,
                draws=d.get("mask"), device=dev)
        with span("optim", dev):
            self.opt.zero_grad(set_to_none=False)
        out = self.unet(x, d.get("unet"), self.generator)
        self.out = out.detach()
        with span("loss", dev, backward=True) as s:
            loss = s.out(bce_with_logits(out, self.gt).mean())
        with span("backward", dev):
            loss.backward()
        with span("optim", dev):
            self.opt.step()
        return loss.detach()

    def step(self, i: int, draws: Optional[dict] = None) -> torch.Tensor:
        """Step ``i`` of the schedule: its rate filled in place, then the
        step, replayed where it is captured. Returns the loss, which the
        next step overwrites on the graphed path."""
        if self.program is not None and draws is not None:
            raise ValueError("injected draws exist only on the eager path "
                             "(graphed=False); the captured step draws "
                             "from its generator")
        self.lr.fill_(self.sched(i))
        if self.program is None:
            return self.body(draws)
        if self.program.graph is not None:
            return self.program()
        with autotuned_convolutions():
            if not self.program.warming:
                # the eager steps' freed activations stay cached outside
                # the graph's pool, which the capture cannot draw on: at
                # the stage's batch (every frame, [64, 3, 66, 1030]) the
                # two copies would not fit the card together
                torch.cuda.synchronize(self.x_full.device)
                torch.cuda.empty_cache()
            return self.program()

    def run(self, start: int, stop: int, *, log_fn=None,
            log_every: int = 50, draws: Optional[list] = None) -> list:
        """Steps ``start`` to ``stop - 1`` of the schedule with the U-Net in
        training mode (in eval mode again after). Returns the loss of each
        ``log_every``-th step, read on the host there alone. ``draws[i]``
        replaces step i's draws (the eager path only): ``{"mask":
        random_box_mask draws, "unet": UNet draws}``."""
        losses = []
        self.unet.train()
        try:
            for i in range(start, stop):
                loss = self.step(i, draws[i] if draws is not None else None)
                if i % log_every == 0:
                    lv = float(loss)
                    losses.append(lv)
                    if log_fn:
                        log_fn(f"[refine] iter {i} loss {lv:.5f}")
        finally:
            self.unet.eval()
        return losses


def refine_steps(unet: UNet, unet_input, raydrop_gt, *, steps: int = 1000,
                 lr: float = 1e-3, graphed: Optional[bool] = None
                 ) -> RefineSteps:
    """The refine stage's ``RefineSteps`` on ``unet``'s device, from
    (rendered raydrop, intensity, depth) ``unet_input`` [B, 3, H, W] to the
    GT raydrop ``raydrop_gt`` [B, 1, H, W] (arrays or tensors), over a
    ``steps``-step schedule at peak rate ``lr``."""
    dev = next(unet.parameters()).device
    x_full = torch.as_tensor(unet_input, dtype=torch.float32, device=dev)
    gt = torch.as_tensor(raydrop_gt, dtype=torch.float32, device=dev)
    return RefineSteps(unet, x_full, gt, steps=steps, lr=lr, graphed=graphed)


def refine_raydrop(unet: UNet, unet_input: np.ndarray,
                   raydrop_gt: np.ndarray, *, steps: int = 1000,
                   lr: float = 1e-3, log_fn=None,
                   log_every: int = 50, draws: Optional[list] = None):
    """Train ``unet`` in place on (rendered raydrop, intensity, depth) ->
    GT raydrop: every step of ``refine_steps``'s schedule (graphed on the
    card) through ``RefineSteps.run``, which returns the logged losses."""
    return refine_steps(unet, unet_input, raydrop_gt, steps=steps,
                        lr=lr).run(0, steps, log_fn=log_fn,
                                   log_every=log_every, draws=draws)


@torch.no_grad()
def apply_refinement(unet: UNet, pred_raydrop, pred_intensity, pred_depth):
    """The refined raydrop [H, W] (numpy) of one rendered pano's raydrop,
    intensity and depth [H, W], in eval mode."""
    dev = next(unet.parameters()).device
    x = torch.stack([torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                     device=dev)
                     for a in (pred_raydrop, pred_intensity, pred_depth)])
    unet.eval()
    return unet(x[None])[0, 0].cpu().numpy()
