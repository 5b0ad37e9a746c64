"""Device-side pixel samplers (random, error-map weighted, patch) and the
error-map update (counterpart of ``nvsf_tpu/data/sampler.py``).

Every sampler takes an optional ``draws`` dict that replaces its random
draws (the tests feed JAX's draws through it):
  - random: ``inds`` [N] pixel ids;
  - error map: ``gumbel`` [He*We] (or ``coarse`` [N] coarse ids when N
    exceeds the map's cells and sampling falls back to categorical with
    replacement), ``ux`` / ``uy`` [N] uniform jitter;
  - patch with error map: ``gumbel`` / ``coarse`` and ``ux`` / ``uy``
    [num_patch];
  - patch without: ``x`` / ``y`` [num_patch] integer corners.
"""

from __future__ import annotations

from typing import Optional

import torch


def _rand(draws, key, shape, generator, device):
    if draws is not None and key in draws:
        return draws[key].to(device)
    return torch.rand(shape, generator=generator, device=device)


def _weighted_coarse(log_weights, k, generator, draws):
    """k coarse cells drawn in proportion to softmax(log_weights): without
    replacement (Gumbel top-k) when k fits, else with replacement (the
    inverse CDF of uniform draws; ``torch.multinomial`` would synchronise
    with the host to check its weights)."""
    dev = log_weights.device
    n = log_weights.shape[0]
    if k > n:
        if draws is not None and "coarse" in draws:
            return draws["coarse"].to(dev).long()
        cdf = torch.cumsum(torch.softmax(log_weights, dim=0), dim=0)
        u = torch.rand((k,), generator=generator, device=dev) * cdf[-1]
        return torch.searchsorted(cdf, u, right=True).clamp_max(n - 1)
    if draws is not None and "gumbel" in draws:
        g = draws["gumbel"].to(dev)
    else:
        u = torch.rand((n,), generator=generator, device=dev)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.topk(log_weights + g, k).indices


def sample_random_indices(H, W, N, generator=None, draws=None, device=None):
    if draws is not None and "inds" in draws:
        return draws["inds"].to(device).long()
    return torch.randint(0, H * W, (N,), generator=generator, device=device)


def sample_error_map_indices(error_map, H, W, N, generator=None,
                             draws=None):
    """Error-map weighted sampling on the coarse map, upscaled with jitter.
    Returns flat indices [N] into H*W."""
    He, We = error_map.shape
    dev = error_map.device
    logw = torch.log(torch.clamp(error_map.reshape(-1), min=1e-12))
    coarse = _weighted_coarse(logw, N, generator, draws)
    sx, sy = W / We, H / He
    ix = (coarse % We).to(torch.float32)
    iy = (coarse // We).to(torch.float32)
    ux = _rand(draws, "ux", (N,), generator, dev)
    uy = _rand(draws, "uy", (N,), generator, dev)
    x = torch.clamp((ix * sx + ux * sx).to(torch.int64), 0, W - 1)
    y = torch.clamp((iy * sy + uy * sy).to(torch.int64), 0, H - 1)
    return y * W + x


def sample_patch_indices(H, W, N, patch_h, patch_w, error_map=None,
                         generator=None, draws=None, device=None):
    """Random (or error-map weighted) patch corners plus the dense patch
    offsets; indices [N] patch-major (reshape to [num_patch, ph, pw])."""
    num_patch = N // (patch_h * patch_w)
    if error_map is not None:
        dev = error_map.device
        He, We = error_map.shape
        logw = torch.log(torch.clamp(error_map.reshape(-1), min=1e-12))
        coarse = _weighted_coarse(logw, num_patch, generator, draws)
        s_w, s_h = W / We, H / He
        ix = (coarse % We).to(torch.float32)
        iy = (coarse // We).to(torch.float32)
        ux = _rand(draws, "ux", (num_patch,), generator, dev)
        uy = _rand(draws, "uy", (num_patch,), generator, dev)
        inds_x = torch.clamp((ix * s_w + ux * s_w).to(torch.int64), 0,
                             W - patch_w)
        inds_y = torch.clamp((iy * s_h + uy * s_h).to(torch.int64), 0,
                             H - patch_h)
    else:
        dev = device
        if draws is not None and "x" in draws:
            inds_x = draws["x"].to(dev).long()
            inds_y = draws["y"].to(dev).long()
        else:
            inds_x = torch.randint(0, W - patch_w, (num_patch,),
                                   generator=generator, device=dev)
            inds_y = torch.randint(0, H - patch_h, (num_patch,),
                                   generator=generator, device=dev)
    pi, pj = torch.meshgrid(torch.arange(patch_h, device=dev),
                            torch.arange(patch_w, device=dev), indexing="ij")
    rows = inds_y[:, None] + pi.reshape(1, -1)
    cols = inds_x[:, None] + pj.reshape(1, -1)
    return (rows * W + cols).reshape(-1)


def sample_indices(H, W, N, patch_size=1, error_map=None,
                   use_error_map=False, generator=None,
                   draws: Optional[dict] = None, device=None):
    """Dispatch between the three sampling modes."""
    if isinstance(patch_size, int):
        ph = pw = patch_size
    elif len(patch_size) == 1:
        ph = pw = patch_size[0]
    else:
        ph, pw = patch_size
    if ph > 1:
        return sample_patch_indices(
            H, W, N, ph, pw, error_map if use_error_map else None,
            generator, draws, device)
    if use_error_map and error_map is not None:
        return sample_error_map_indices(error_map, H, W, N, generator, draws)
    return sample_random_indices(H, W, N, generator, draws, device)


def update_error_map(error_map, inds, per_ray_error, H, W):
    """Per-ray loss -> min-max normalized -> [1, 1e3] -> coarse-pixel EMA
    0.1 * old + 0.9 * new. Where several rays map to one coarse pixel,
    which write lands is unspecified."""
    He, We = error_map.shape
    err = per_ray_error.to(torch.float32)
    lo, hi = err.min(), err.max()
    err = (err - lo) / (hi - lo + torch.finfo(torch.float32).eps)
    err = err * (1e3 - 1.0) + 1.0
    sh, sw = He / H, We / W
    ey = ((inds // W).to(torch.float32) * sh).to(torch.int64)
    ex = ((inds % W).to(torch.float32) * sw).to(torch.int64)
    new = 0.1 * error_map[ey, ex] + 0.9 * err
    out = error_map.clone()
    out[ey, ex] = new
    return out
