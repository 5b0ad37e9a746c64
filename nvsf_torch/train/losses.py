"""Loss terms (counterpart of ``nvsf_tpu/train/losses.py``): those of the
training step, and the library's ``mape_loss`` and
``eff_distortion_loss``. Elementwise criteria keep reduction='none'
semantics."""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from nvsf_torch.lib.constants import device_constant
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


def cosine_similarity(pred, gt, dim=-1, eps=1e-8):
    num = (pred * gt).sum(dim)
    den = torch.linalg.norm(pred, dim=dim) * torch.linalg.norm(gt, dim=dim)
    return num / torch.clamp(den, min=eps)


def make_criterion(name: str, scale: float = 1.0) -> Callable:
    """Criterion by config name (huber's delta is 0.2 * scene scale)."""
    table = {
        "mse": mse,
        "l1": l1,
        "smoothl1": lambda p, g: smooth_l1(p, g, 0.1),
        "huber": lambda p, g: huber(p, g, 0.2 * scale),
        "bce": bce_with_logits,
        "cos": cosine_similarity,
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
    d1, d2 = chamfer_distance(pred_pts, gt_pts, use_kernel=False)
    return 0.5 * (d1 + d2).mean()


def flow_consistency_loss(pc, pc_mask, pc_next, pc_next_mask, flow):
    """One direction of the scene-flow loss: chamfer(pc + flow, pc_next)
    summed, plus the mean L1 flow magnitude."""
    d1, d2 = chamfer_distance(pc + flow, pc_next, a_mask=pc_mask,
                              b_mask=pc_next_mask, use_kernel=False)
    cd = 0.5 * (d1.sum() + d2.sum())
    n_valid = torch.clamp(pc_mask.sum(), min=1)
    mag = torch.where(pc_mask[:, None], flow.abs(), 0.0).sum() \
        / (n_valid * 3)
    return cd + mag


def urf_line_of_sight_loss(weights, z_vals, gt_depth, global_step, iters):
    """Urban Radiance Fields line-of-sight loss: empty-space suppression
    outside gt +- eps plus a gaussian match inside, eps shrinking with
    training progress."""
    eps = 0.02 * torch.pow(
        0.1, torch.clamp(torch.as_tensor(global_step) / iters, max=1.0))
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


# ----------------------------------------------------------------------
# patch structural regularizers (``nvsf_tpu/train/losses.py:138-214``)
# ----------------------------------------------------------------------

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _conv2d_same(x, k):
    """x: [B, H, W]; k: 3x3 taps -> cross-correlation with zero padding
    (XLA's 'SAME' convolution)."""
    w = device_constant(k, x.dtype, x.device)[None, None]
    return F.conv2d(x[:, None], w, padding=1)[:, 0]


def _diff_replicate(a, dim):
    """a[i] - a[i + 1] along ``dim``, the last difference repeated."""
    n = a.shape[dim]
    d = a.narrow(dim, 0, n - 1) - a.narrow(dim, 1, n - 1)
    return torch.cat([d, d.narrow(dim, n - 2, 1)], dim=dim)


def patch_gradients(depth_patches, sobel=False):
    """x / y gradients of [B, H, W] patches: Sobel, or forward differences
    with the last row / column repeated."""
    if sobel:
        return _conv2d_same(depth_patches, _SOBEL_X), \
            _conv2d_same(depth_patches, _SOBEL_Y)
    return _diff_replicate(depth_patches, -1), \
        _diff_replicate(depth_patches, -2)


def pano_double_gradients(pano_depth, scale):
    """Second differences |d/dx|, |d/dy| of GT panos [..., H, W] (in
    meters), which mask the gradient loss to smooth regions."""
    d = pano_depth / scale
    gx = _diff_replicate(d, -1)
    gy = _diff_replicate(d, -2)
    return _diff_replicate(gx.abs(), -1), _diff_replicate(gy.abs(), -2)


def structural_regularizers(pred_depth_patches, gt_depth_patches,
                            gt_raydrop_patches, grad_mask_x, grad_mask_y,
                            criterion_grad, cfg_flags):
    """Edge-aware smoothness, spatial smoothness, TV and gradient-matching
    terms on [B, ph, pw] depth patches in meters. ``cfg_flags`` holds
    grad_norm_smooth, spatial_smooth, tv_loss, grad_loss, sobel_grad,
    depth_grad_loss_is_cos and the alpha_* weights."""
    sobel = cfg_flags.get("sobel_grad", False)
    gx, gy = patch_gradients(pred_depth_patches, sobel)
    loss = 0.0
    if cfg_flags.get("grad_norm_smooth"):
        loss = loss + cfg_flags["alpha_grad_norm"] * (
            torch.exp(-gx.abs()) + torch.exp(-gy.abs())).sum()
    if cfg_flags.get("spatial_smooth"):
        loss = loss + cfg_flags["alpha_spatial"] * (gx ** 2 + gy ** 2).sum()
    if cfg_flags.get("tv_loss"):
        loss = loss + cfg_flags["alpha_tv"] * (gx.abs() + gy.abs()).sum()
    if cfg_flags.get("grad_loss"):
        ggx, ggy = patch_gradients(gt_depth_patches, sobel)
        mask_dx = gt_raydrop_patches * grad_mask_x
        mask_dy = gt_raydrop_patches * grad_mask_y
        B, ph, pw = pred_depth_patches.shape
        if cfg_flags.get("depth_grad_loss_is_cos"):
            cx = criterion_grad((gx * mask_dx).reshape(B, -1),
                                (ggx * mask_dx).reshape(B, -1))
            cy = criterion_grad((gy * mask_dy).reshape(B, -1),
                                (ggy * mask_dy).reshape(B, -1))
            gl = ((1 - cx) + (1 - cy))[:, None, None].expand(B, ph, pw)
        else:
            gl = criterion_grad(gx * mask_dx, ggx * mask_dx) \
                + criterion_grad(gy * mask_dy, ggy * mask_dy)
        loss = loss + cfg_flags["alpha_grad"] * gl.sum()
    return loss


def mape_loss(pred, gt, eps=1e-2):
    """Mean-absolute-percentage style loss, elementwise (in the
    reference's loss library, ``nvsf/nerf/loss.py``; its trainer does not
    call it)."""
    return (pred - gt).abs() / (gt.abs() + eps)


def eff_distortion_loss(weights, z_vals):
    """The O(T) mip-NeRF-360 distortion loss of the reference's
    ``EffDistLoss`` (``nvsf/nerf/loss.py:29-87``; unused by its trainer):
    sum_ij w_i w_j |m_i - m_j| + 1/3 sum_i w_i^2 d_i through prefix sums.
    weights, z_vals (interval midpoints): [N, T] -> [N]."""
    m, w = z_vals, weights
    wm = w * m
    cw = torch.cumsum(w, dim=-1) - w
    cwm = torch.cumsum(wm, dim=-1) - wm
    cross = 2.0 * (wm * cw - w * cwm).sum(dim=-1)
    d = torch.cat([m[..., 1:] - m[..., :-1], torch.zeros_like(m[..., :1])],
                  dim=-1)
    return cross + (w * w * d).sum(dim=-1) / 3.0


def scrub_loss(loss):
    """NaN -> 0, Inf -> 1e5."""
    loss = torch.where(torch.isnan(loss), 0.0, loss)
    return torch.where(torch.isinf(loss), 1e5, loss)
