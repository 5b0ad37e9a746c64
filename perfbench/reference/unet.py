"""The U-Net ray-drop refiner's refine step in plain float32 torch, the
reference that the ``refine`` entry holds the program to: the forward, the
BCE loss, the gradients, the BatchNorm running-statistic update and one
Adam step at the OneCycle rate, from a given state. Written from the
upstream's description (``nvsf/nerf/models/unet.py``: UNet 3 -> 1, widths
32-64-128-256-256, attention bottleneck; ``nvsf/nerf/trainer.py:905-1017``:
``Trainer.refine``), in plain torch operations with TF32 off for matrix
products and cuDNN (``exact``). Imports nothing of the program.

  - The U-Net: a bias-free 1x1 in-conv; four downs, each a 2x2 max-pool
    and a DoubleConv; an attention block at the bottleneck; four ups, each
    a bilinear x2 upsampling, a pad to the skip's size and the skip
    concatenated before it, and a DoubleConv whose middle width is its
    input width; BN -> ReLU -> 1x1 out-conv -> sigmoid. A DoubleConv is
    (BN -> ReLU -> Dropout2d -> bias-free 3x3 'same' conv) twice. The
    attention block: BN -> 1x1 qkv conv -> softmax(q k^T / sqrt(head
    width)) v over the bottleneck's positions in each head -> 1x1
    projection, added to its input; in training every logit that a
    Bernoulli(dropout) draw drops gets -1e12 added.
  - The step: the input with up to ``box_num_max`` random boxes zeroed
    (each at most ``box_frac`` of H and W), the U-Net in training mode,
    BCE-with-logits of the *sigmoid output* against the GT ray drop, mean
    over every pixel (a reference behaviour of the upstream), Adam
    (0.9, 0.999, eps 1e-8 outside the square root, no weight decay) at the
    OneCycle rate of the step (cosine, 30 % warm-up from max / 25 down to
    max / 25 / 1e4, over the stage's steps).

Departures from the upstream, each the port's reference behaviour (the JAX
package's code, which the port follows):

  - BatchNorm's running statistics take the *biased* batch variance, with
    momentum 0.9 (0.9 old + 0.1 batch); ``nn.BatchNorm2d`` would keep the
    unbiased one. The normalisation itself uses the biased variance, as
    ``nn.BatchNorm2d`` does in training.
  - The x2 upsampling is bilinear with half-pixel centres
    (``align_corners=False``), what ``jax.image.resize`` computes; the JAX
    package's docstring claims ``align_corners=True``, which is kept here
    as a planted fault (``align_corners`` below).
  - The random draws come from one ``torch.Generator`` on the step's
    device, seeded ``GENERATOR_SEED`` as the program seeds its own, taken
    in the program's order (``draws``); the upstream draws from torch's
    global generator.

``conv`` computes every convolution: ``f32_conv`` for the reference,
``bf16_conv`` for the control in the precision below the configuration's
(TF32 convolutions).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

# the program seeds its refine stage's generator so
GENERATOR_SEED = 0
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


@contextlib.contextmanager
def exact():
    """TF32 off for matrix products and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def f32_conv(x, w):
    """Stride-1 convolution with 'same' zero padding, in float32."""
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


def bf16_conv(x, w):
    """The same with inputs and weights rounded to bfloat16."""
    return F.conv2d(x.bfloat16(), w.bfloat16(),
                    padding=w.shape[-1] // 2).float()


def onecycle(max_lr: float, total: int, step: int) -> float:
    """torch's OneCycleLR (cosine, pct_start 0.3, div 25, final div 1e4)
    at ``step`` (the last step's rate after the end)."""
    init = max_lr / 25.0
    low = init / 1e4
    up = int(0.3 * total)
    step = min(step, total - 1)
    if step < up:
        return init + (max_lr - init) * 0.5 * (
            1 - math.cos(math.pi * step / max(up, 1)))
    t = min(max((step - up) / max(total - up, 1), 0.0), 1.0)
    return low + (max_lr - low) * 0.5 * (1 + math.cos(math.pi * t))


def widths(u: dict):
    """(down, up) DoubleConvs as (site, in, mid, out), the U-Net's."""
    C = u["channels"]
    down = [(f"down{i + 1}", a, b, b) for i, (a, b) in enumerate(
        [(C, 2 * C), (2 * C, 4 * C), (4 * C, 8 * C), (8 * C, 8 * C)])]
    up = [(f"up{i + 1}", a, a, b) for i, (a, b) in enumerate(
        [(16 * C, 4 * C), (8 * C, 2 * C), (4 * C, C), (2 * C, C)])]
    return down, up


# ----------------------------------------------------------------------
# the draws
# ----------------------------------------------------------------------

def draws(gen: torch.Generator, shape, u: dict, r: dict) -> dict:
    """One step's draws from ``gen``, in the program's order: the box
    mask's (``n_active``, then each box's ``ys``, ``xs``, ``sy``, ``sx``),
    then each Dropout2d keep mask [B, C] and the attention's drop mask
    [B, heads, HW, HW] in the order of the U-Net's forward."""
    B, _, H, W = shape
    dev = gen.device
    n = r["box_num_max"]
    by = max(int(r["box_frac"] * H), 2)
    bx = max(int(r["box_frac"] * W), 2)

    def randint(lo, hi, size=()):
        return torch.randint(lo, hi, size, generator=gen, device=dev)
    mask = {"n_active": randint(0, n), "ys": randint(0, H - by, (n,)),
            "xs": randint(0, W - bx, (n,)), "sy": randint(1, by, (n,)),
            "sx": randint(1, bx, (n,))}
    p = u["dropout"]
    unet = {}
    if p == 0.0:
        return {"mask": mask, "unet": unet}

    def keep(site, ch):
        unet[site] = torch.rand((B, ch), generator=gen, device=dev) < 1 - p
    down, up = widths(u)
    for site, a, mid, _ in down:
        keep(f"{site}.drop1", a)
        keep(f"{site}.drop2", mid)
    hw = (H // 16) * (W // 16)
    unet["attn"] = torch.rand((B, u["num_heads"], hw, hw), generator=gen,
                              device=dev) < p
    for site, a, mid, _ in up:
        keep(f"{site}.drop1", a)
        keep(f"{site}.drop2", mid)
    return {"mask": mask, "unet": unet}


def box_mask(shape, d: dict, r: dict) -> torch.Tensor:
    """Ones, with the first ``n_active`` boxes zeroed."""
    B, C, H, W = shape
    m = torch.ones((H, W), dtype=torch.float32, device=d["ys"].device)
    for i in range(int(d["n_active"])):
        y, x = int(d["ys"][i]), int(d["xs"][i])
        m[y:y + int(d["sy"][i]), x:x + int(d["sx"][i])] = 0.0
    return m.expand(shape)


# ----------------------------------------------------------------------
# the U-Net in training mode
# ----------------------------------------------------------------------

def batch_norm(P, S, name, x, new_stats):
    """Normalised by the batch's mean and biased variance, each channel's
    over the batch and every pixel; the running statistics' update
    (momentum 0.9, biased variance) into ``new_stats``. Written out and
    differentiated by autograd: on the CPU, ``F.batch_norm``'s own
    backward in float32 gave input gradients 0.26 % off their float64
    values at the U-Net's initial weights, where a batch-normalised
    layer's input gradient is a small remainder of cancelling terms."""
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    with torch.no_grad():
        for k, v in (("mean", mean), ("var", var)):
            new_stats[f"{name}.{k}"] = BN_MOMENTUM * S[f"{name}.{k}"] \
                + (1 - BN_MOMENTUM) * v

    def per_channel(t):
        return t[None, :, None, None]
    return (x - per_channel(mean)) * per_channel(torch.rsqrt(var + BN_EPS)) \
        * per_channel(P[f"{name}.scale"]) + per_channel(P[f"{name}.bias"])


def double_conv(P, S, site, x, d, p, conv, new_stats):
    for j in (1, 2):
        h = torch.relu(batch_norm(P, S, f"{site}.bn{j}", x, new_stats))
        if p > 0.0:
            keep = d[f"{site}.drop{j}"].to(h.dtype)
            h = h * keep[:, :, None, None] / (1.0 - p)
        x = conv(h, P[f"{site}.conv{j}"])
    return x


def attention(P, S, x, d, u, conv, new_stats):
    B, C, H, W = x.shape
    nh = u["num_heads"]
    hd = C // nh
    qkv = conv(batch_norm(P, S, "attn.norm", x, new_stats), P["attn.qkv"])
    q, k, v = (t.reshape(B, nh, hd, H * W) for t in qkv.chunk(3, dim=1))
    logits = q.transpose(2, 3) @ k / math.sqrt(hd)       # [B, nh, HW, HW]
    if "attn" in d:
        logits = logits + d["attn"].to(logits.dtype) * -1e12
    h = torch.softmax(logits, dim=-1) @ v.transpose(2, 3)  # [B, nh, HW, hd]
    h = h.transpose(2, 3).reshape(B, C, H, W)
    return x + conv(h, P["attn.proj"])


def forward(P, S, x, d: dict, u: dict, conv: Callable = f32_conv,
            align_corners: bool = False):
    """(sigmoid output [B, 1, H, W], the new running statistics)."""
    p = u["dropout"]
    new_stats: Dict[str, torch.Tensor] = {}
    down, up = widths(u)
    h = conv(x, P["inc"])
    skips = [h]
    for site, *_ in down:
        h = double_conv(P, S, site, F.max_pool2d(h, 2), d, p, conv,
                        new_stats)
        skips.append(h)
    h = attention(P, S, skips.pop(), d, u, conv, new_stats)
    for site, *_ in up:
        skip = skips.pop()
        h = F.interpolate(h, scale_factor=2, mode="bilinear",
                          align_corners=align_corners)
        dy, dx = skip.shape[2] - h.shape[2], skip.shape[3] - h.shape[3]
        h = F.pad(h, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))
        h = double_conv(P, S, site, torch.cat([skip, h], dim=1), d, p, conv,
                        new_stats)
    h = torch.relu(batch_norm(P, S, "outc.bn", h, new_stats))
    return torch.sigmoid(conv(h, P["outc.conv"])), new_stats


# ----------------------------------------------------------------------
# one step, and the checked steps
# ----------------------------------------------------------------------

def step(state: dict, x_full, gt, d: dict, lr: float, u: dict, r: dict,
         conv: Callable = f32_conv, align_corners: bool = False) -> dict:
    """One refine step from ``state`` (``params``, ``buffers``, ``adam``:
    by parameter ``exp_avg``, ``exp_avg_sq`` and ``step``, or None before
    the first) on one step's draws ``d``: its ``out``, ``loss``,
    ``grads``, and the ``params`` and ``buffers`` after it."""
    dev = x_full.device
    P = {k: v.to(dev, copy=True).requires_grad_(True)
         for k, v in state["params"].items()}
    S = {k: v.to(dev) for k, v in state["buffers"].items()}
    x = x_full * box_mask(x_full.shape, d["mask"], r)
    out, new_stats = forward(P, S, x, d["unet"], u, conv, align_corners)
    loss = F.binary_cross_entropy_with_logits(out, gt)
    names = list(P)
    grads = dict(zip(names, torch.autograd.grad(loss, [P[k] for k in names])))
    return {"out": out.detach(), "loss": float(loss.detach()),
            "grads": grads, "params": adam(state, grads, lr),
            "buffers": {**S, **new_stats}}


@torch.no_grad()
def adam(state: dict, grads: dict, lr: float) -> dict:
    """The parameters after one Adam step from ``state`` on ``grads``, on
    the gradients' device."""
    params = {}
    for k, g in grads.items():
        a, dev = state["adam"].get(k), g.device
        m0 = a["exp_avg"].to(dev) if a else torch.zeros_like(g)
        v0 = a["exp_avg_sq"].to(dev) if a else torch.zeros_like(g)
        t = (float(a["step"]) if a else 0.0) + 1.0
        m = 0.9 * m0 + 0.1 * g
        v = 0.999 * v0 + 0.001 * g * g
        denom = (v / (1 - 0.999 ** t)).sqrt() + 1e-8
        params[k] = state["params"][k].to(dev) \
            - lr * (m / (1 - 0.9 ** t)) / denom
    return params


def checked_steps(states: List[dict], x_full, gt, u: dict, r: dict,
                  conv: Callable = f32_conv, align_corners: bool = False,
                  host: Optional[Callable] = None) -> List[dict]:
    """The stage's first steps, step k from ``states[k]``, each on its own
    draws, taken in turn from one generator as the program's are. ``host``
    moves each result off the device."""
    gen = torch.Generator(device=x_full.device).manual_seed(GENERATOR_SEED)
    out = []
    with exact():
        for k, state in enumerate(states):
            res = step(state, x_full, gt, draws(gen, x_full.shape, u, r),
                       onecycle(r["lr"], r["steps"], k), u, r, conv,
                       align_corners)
            out.append(host(res) if host else res)
            del res
    return out
