"""Loss terms of the training step (counterpart of the functions of
``nvsf_tpu/train/losses.py`` that the joint step calls). Elementwise
criteria keep reduction='none' semantics."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch

from nvsf_torch.ops.chamfer import chamfer_distance


def mse(pred, gt):
    return (pred - gt) ** 2


def l1(pred, gt):
    return (pred - gt).abs()


def smooth_l1(pred, gt, beta: float = 0.1):
    d = (pred - gt).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def huber(pred, gt, delta: float = 1.0):
    d = (pred - gt).abs()
    return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))


def bce_with_logits(pred, gt):
    return torch.clamp(pred, min=0) - pred * gt \
        + torch.log1p(torch.exp(-pred.abs()))


def make_criterion(name: str, scale: float = 1.0) -> Callable:
    """Criterion by config name (huber's delta is 0.2 * scene scale)."""
    table = {
        "mse": mse,
        "l1": l1,
        "smoothl1": lambda p, g: smooth_l1(p, g, 0.1),
        "huber": lambda p, g: huber(p, g, 0.2 * scale),
        "bce": bce_with_logits,
    }
    return table[name]


def lidar_losses(pred_raydrop, pred_intensity, pred_depth, gt_raydrop,
                 gt_intensity, gt_depth, criterion: Dict, alpha_d=1.0,
                 alpha_i=0.1, alpha_r=0.01, smooth_factor=0.0):
    """Depth / intensity / ray-drop terms -> (per-ray loss [N], parts)."""
    gt_raydrop_s = torch.clamp(gt_raydrop, smooth_factor, 1.0 - smooth_factor)
    loss_rd = alpha_r * criterion["raydrop"](pred_raydrop, gt_raydrop_s)
    loss_d = alpha_d * criterion["depth"](pred_depth, gt_depth)
    loss_i = alpha_i * criterion["intensity"](pred_intensity, gt_intensity)
    total = loss_d + loss_rd + loss_i
    return total, {"loss_d": loss_d.sum(), "loss_i": loss_i.sum(),
                   "loss_rd": loss_rd.sum()}


def lidar_chamfer_loss(rays_d, pred_depth, gt_depth, scale):
    """Chamfer distance between the predicted and GT point clouds of the
    sampled rays, in meters."""
    pred_pts = rays_d * (pred_depth / scale)[:, None]
    gt_pts = rays_d * (gt_depth / scale)[:, None]
    d1, d2 = chamfer_distance(pred_pts, gt_pts)
    return 0.5 * (d1 + d2).mean()


def flow_consistency_loss(pc, pc_mask, pc_next, pc_next_mask, flow):
    """One direction of the scene-flow loss: chamfer(pc + flow, pc_next)
    summed, plus the mean L1 flow magnitude."""
    d1, d2 = chamfer_distance(pc + flow, pc_next, a_mask=pc_mask,
                              b_mask=pc_next_mask)
    cd = 0.5 * (d1.sum() + d2.sum())
    n_valid = torch.clamp(pc_mask.sum(), min=1)
    mag = torch.where(pc_mask[:, None], flow.abs(), 0.0).sum() \
        / (n_valid * 3)
    return cd + mag


def urf_line_of_sight_loss(weights, z_vals, gt_depth, global_step, iters):
    """Urban Radiance Fields line-of-sight loss: empty-space suppression
    outside gt +- eps plus a gaussian match inside, eps shrinking with
    training progress."""
    eps = 0.02 * 0.1 ** min(global_step / iters, 1.0)
    gt = gt_depth[:, None]
    depth_mask = gt > 0.0
    mask_empty = (z_vals < gt - eps) | (z_vals > gt + eps)
    denom = torch.clamp(depth_mask.sum(), min=1)
    loss_empty = ((mask_empty * weights) ** 2).sum() / denom
    mask_near = (z_vals > gt - eps) & (z_vals < gt + eps)
    distance = mask_near * (z_vals - gt)
    sigma_g = eps / 3.0
    distr = torch.exp(-(distance ** 2) / (2 * sigma_g ** 2)) \
        / (sigma_g * math.sqrt(2 * math.pi))
    distr = distr / torch.clamp(distr.max(), min=1e-12)
    distr = distr * mask_near
    loss_near = ((mask_near * weights - distr) ** 2).sum() / denom
    return 0.1 * loss_empty + 0.1 * loss_near


def scrub_loss(loss):
    """NaN -> 0, Inf -> 1e5."""
    loss = torch.where(torch.isnan(loss), 0.0, loss)
    return torch.where(torch.isinf(loss), 1e5, loss)
