"""U-Net ray-drop refiner (counterpart of ``nvsf_tpu/models/unet.py``,
which rebuilds ``nvsf/nerf/models/unet.py``).

1x1 in-conv -> 4 x (2x2 max-pool + DoubleConv) down (32-64-128-256-256)
-> multi-head attention bottleneck -> 4 x (bilinear x2 up + skip concat +
DoubleConv) -> BN / ReLU / 1x1 out-conv -> sigmoid. DoubleConv is
(BN -> ReLU -> Dropout2d -> bias-free 3x3 conv) x 2.

Parameters and statistics carry the names of the JAX params and stats
trees (``down1.bn1.scale``, ``down1.conv1``, ``attn.qkv``, ...; the BN
running ``mean`` / ``var`` are buffers), so ``bridge.py`` copies them
across unchanged. As in the reference implementation:

  - BN in training normalizes by the batch mean and *biased* variance and
    keeps running averages of the same with momentum 0.9
    (0.9 * old + 0.1 * batch); ``nn.BatchNorm2d`` would keep the unbiased
    variance, so the update is written out here;
  - the x2 upsampling is ``jax.image.resize(..., "bilinear")``: half-pixel
    centers, i.e. ``align_corners=False`` (the JAX docstring's
    ``align_corners=True`` is not what its code does);
  - training attention adds -1e12 to logits dropped by a Bernoulli(0.1)
    draw.

The forward is three spans (``train/profiler.py``), each with its
backward: ``unet.down`` (the in-conv and the four downs), ``unet.attn``
and ``unet.up`` (the four ups and the out-conv).

Every random draw of a training forward can be injected through
``draws``: ``{site: mask}`` with ``downI.drop1`` / ``downI.drop2`` /
``upI.drop1`` / ``upI.drop2`` Dropout2d keep masks [B, C] and ``attn`` the
attention's drop mask [B, heads, HW, HW].
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from nvsf_torch.train.profiler import span

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def _conv_weight(out_ch, in_ch, k, generator):
    bound = (1.0 / (in_ch * k * k)) ** 0.5
    w = torch.rand((out_ch, in_ch, k, k), generator=generator) * 2 - 1
    return nn.Parameter(w * bound)


def _conv(x, w):
    """Stride-1 convolution with 'SAME' zero padding."""
    return F.conv2d(x, w, padding=w.shape[-1] // 2)


class BatchNorm(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + BN_EPS)
        return (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            * self.scale[None, :, None, None] \
            + self.bias[None, :, None, None]


class _Draws:
    """The training forward's random draws: injected ones by site name,
    the rest from ``generator``."""

    def __init__(self, draws, generator, device):
        self.draws = draws or {}
        self.generator = generator
        self.device = device

    def bernoulli(self, site, p, shape):
        if site in self.draws:
            return self.draws[site].to(self.device, torch.bool)
        return torch.rand(shape, generator=self.generator,
                          device=self.device) < p


class DoubleConv(nn.Module):
    def __init__(self, in_ch, out_ch, mid_ch=None, dropout=0.1,
                 generator=None):
        super().__init__()
        mid_ch = mid_ch or out_ch
        self.dropout = dropout
        self.bn1 = BatchNorm(in_ch)
        self.conv1 = _conv_weight(mid_ch, in_ch, 3, generator)
        self.bn2 = BatchNorm(mid_ch)
        self.conv2 = _conv_weight(out_ch, mid_ch, 3, generator)

    def _dropout2d(self, x, site, draws):
        if not self.training or self.dropout == 0.0:
            return x
        keep = draws.bernoulli(site, 1.0 - self.dropout, x.shape[:2])
        return x * keep[:, :, None, None] / (1.0 - self.dropout)

    def forward(self, x, site, draws):
        h = self._dropout2d(torch.relu(self.bn1(x)), f"{site}.drop1", draws)
        h = _conv(h, self.conv1)
        h = self._dropout2d(torch.relu(self.bn2(h)), f"{site}.drop2", draws)
        return _conv(h, self.conv2)


class Attention(nn.Module):
    def __init__(self, ch, num_heads, dropout, generator=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.norm = BatchNorm(ch)
        self.qkv = _conv_weight(3 * ch, ch, 1, generator)
        self.proj = _conv_weight(ch, ch, 1, generator)

    def forward(self, x, draws):
        B, C, H, W = x.shape
        q, k, v = _conv(self.norm(x), self.qkv).chunk(3, dim=1)
        nh = self.num_heads
        hd = C // nh
        q = q.reshape(B, nh, hd, H * W).transpose(2, 3)     # [B, nh, HW, hd]
        k = k.reshape(B, nh, hd, H * W)                     # [B, nh, hd, HW]
        v = v.reshape(B, nh, hd, H * W).transpose(2, 3)
        w = (q @ k) * hd ** -0.5
        if self.training:
            drop = draws.bernoulli("attn", self.dropout, w.shape)
            w = w + drop.to(w.dtype) * -1e12
        h = torch.softmax(w, dim=-1) @ v                    # [B, nh, HW, hd]
        h = h.transpose(2, 3).reshape(B, C, H, W)
        return x + _conv(h, self.proj)


class OutConv(nn.Module):
    def __init__(self, in_ch, out_ch, generator=None):
        super().__init__()
        self.bn = BatchNorm(in_ch)
        self.conv = _conv_weight(out_ch, in_ch, 1, generator)

    def forward(self, x):
        return _conv(torch.relu(self.bn(x)), self.conv)


def _pad_to(x, target):
    dy = target.shape[2] - x.shape[2]
    dx = target.shape[3] - x.shape[3]
    return F.pad(x, (dx // 2, dx - dx // 2, dy // 2, dy - dy // 2))


class UNet(nn.Module):
    """x [B, 3, H, W] (raydrop, intensity, depth) -> refined raydrop
    [B, 1, H, W] in [0, 1]. ``train()`` mode uses batch statistics, updates
    the running ones and draws the dropouts."""

    def __init__(self, in_channels=3, channels=32, out_channels=1,
                 dropout=0.1, num_heads=8, generator=None):
        super().__init__()
        C = channels
        self.inc = _conv_weight(C, in_channels, 1, generator)
        for i, (ci, co) in enumerate([(C, 2 * C), (2 * C, 4 * C),
                                      (4 * C, 8 * C), (8 * C, 8 * C)]):
            setattr(self, f"down{i + 1}", DoubleConv(
                ci, co, dropout=dropout, generator=generator))
        self.attn = Attention(8 * C, num_heads, dropout, generator)
        for i, (ci, co) in enumerate([(16 * C, 4 * C), (8 * C, 2 * C),
                                      (4 * C, C), (2 * C, C)]):
            setattr(self, f"up{i + 1}", DoubleConv(
                ci, co, mid_ch=ci, dropout=dropout, generator=generator))
        self.outc = OutConv(C, out_channels, generator)

    def forward(self, x, draws: Optional[dict] = None, generator=None):
        d = _Draws(draws, generator, x.device)
        dev = x.device
        with span("unet.down", dev, backward=True) as s:
            h = _conv(x, self.inc)
            feats = [h]
            for i in range(1, 5):
                h = getattr(self, f"down{i}")(F.max_pool2d(h, 2), f"down{i}",
                                              d)
                feats.append(h)
            feats = s.out(feats)
        with span("unet.attn", dev, backward=True) as s:
            h = s.out(self.attn(feats[4], d))
        with span("unet.up", dev, backward=True) as s:
            for i, skip in enumerate((feats[3], feats[2], feats[1],
                                      feats[0])):
                h = F.interpolate(h, scale_factor=2, mode="bilinear",
                                  align_corners=False)
                h = torch.cat([skip, _pad_to(h, skip)], dim=1)
                h = getattr(self, f"up{i + 1}")(h, f"up{i + 1}", d)
            return s.out(torch.sigmoid(self.outc(h)))
