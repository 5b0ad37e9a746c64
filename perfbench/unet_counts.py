"""The U-Net refine step's measures of work: its model FLOPs, and the
bytes and FLOPs of each convolution's calls (forward, the input's gradient
and the weight's), counted from the configuration's widths and the batch's
shape, never from a clock. The least time of a call is
``yardstick.bound_s`` with the FLOPs at the TF32 tensor-core rate.

Peak: NVIDIA H100 SXM data sheet, dense, at 700 W: 494.7 TFLOP/s TF32 on
the tensor cores, the configuration's precision of the convolutions.
"""

from __future__ import annotations

from typing import List, Tuple

from perfbench import yardstick as ys

TF32_FLOP_PER_S = 494.7e12


def _sizes(H: int, W: int) -> List[Tuple[int, int]]:
    """(h, w) at full size and after each of the four 2x2 max-pools."""
    out = [(H, W)]
    for _ in range(4):
        h, w = out[-1]
        out.append((h // 2, w // 2))
    return out


def convs(u: dict, H: int, W: int) -> List[Tuple[str, int, int, int, int]]:
    """Each convolution of one frame's forward: (name, in, out, kernel
    size, output pixels)."""
    C = u["channels"]
    px = [h * w for h, w in _sizes(H, W)]
    out = [("inc", u["in_channels"], C, 1, px[0])]
    for i, (a, b) in enumerate([(C, 2 * C), (2 * C, 4 * C), (4 * C, 8 * C),
                                (8 * C, 8 * C)]):
        out += [(f"down{i + 1}.conv1", a, b, 3, px[i + 1]),
                (f"down{i + 1}.conv2", b, b, 3, px[i + 1])]
    out += [("attn.qkv", 8 * C, 24 * C, 1, px[4]),
            ("attn.proj", 8 * C, 8 * C, 1, px[4])]
    for i, (a, b) in enumerate([(16 * C, 4 * C), (8 * C, 2 * C),
                                (4 * C, C), (2 * C, C)]):
        out += [(f"up{i + 1}.conv1", a, a, 3, px[3 - i]),
                (f"up{i + 1}.conv2", a, b, 3, px[3 - i])]
    return out + [("outc.conv", C, u["out_channels"], 1, px[0])]


def attention_flops(u: dict, H: int, W: int) -> int:
    """One frame's attention products, q k^T and the weights times v."""
    hw = (H // 16) * (W // 16)
    return 2 * 2 * hw * hw * 8 * u["channels"]


def forward_flops(u: dict, B: int, H: int, W: int) -> int:
    """Model FLOPs of the U-Net's forward on a batch: its convolutions and
    its attention products (2 a multiply-add)."""
    conv = sum(2 * a * b * k * k * p for _, a, b, k, p in convs(u, H, W))
    return B * (conv + attention_flops(u, H, W))


def step_flops(u: dict, B: int, H: int, W: int) -> int:
    """Model FLOPs of a training step, forward and backward (x3)."""
    return 3 * forward_flops(u, B, H, W)


def conv_calls(u: dict, B: int, H: int, W: int
               ) -> List[Tuple[str, int, int]]:
    """(name, bytes, FLOPs) of each convolution call of a step in float32:
    the forward (reads x and w, writes y), the input's gradient (reads dy
    and w, writes dx; none for the in-conv, whose input needs none) and
    the weight's (reads x and dy, writes dw)."""
    out = []
    for name, a, b, k, p in convs(u, H, W):
        x, y, w = 4 * B * a * p, 4 * B * b * p, 4 * a * b * k * k
        f = 2 * B * a * b * k * k * p
        out += [(f"{name}.fprop", x + w + y, f),
                (f"{name}.wgrad", x + y + w, f)]
        if name != "inc":
            out.append((f"{name}.dgrad", y + w + x, f))
    return out


def bound_s(nbytes: float, flops: float) -> float:
    """The least time of a call: ``yardstick.bound_s``, its FLOPs at the
    TF32 rate (scaled to the float32 rate that it divides by)."""
    return ys.bound_s(nbytes, flops * ys.FP32_FLOP_PER_S / TF32_FLOP_PER_S)


def conv_bound_s(u: dict, B: int, H: int, W: int) -> float:
    """The least time of a step's convolution calls."""
    return sum(bound_s(n, f) for _, n, f in conv_calls(u, B, H, W))
