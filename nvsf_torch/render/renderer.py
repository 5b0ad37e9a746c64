"""Occupancy-accelerated volume rendering (counterpart of
``nvsf_tpu/render/renderer.py``: ``near_far_from_aabb``,
``stratified_segment_jitter`` and ``run_occupancy``; the dense uniform
``run`` and the eval-time streaming marcher are not ported yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from nvsf_torch.models.field import NVSFField
from nvsf_torch.ops.occupancy import OccupancyGrid


def near_far_from_aabb(rays_o, rays_d, aabb, min_near=0.05):
    """Per-ray slab test against aabb [6] = (min xyz, max xyz) ->
    (nears [N], fars [N]); rays that miss get near == far."""
    eps = 1e-15
    safe = torch.where(rays_d.abs() < eps,
                       torch.where(rays_d >= 0, eps, -eps), rays_d)
    inv_d = 1.0 / safe
    t0 = (aabb[:3] - rays_o) * inv_d
    t1 = (aabb[3:] - rays_o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    nears = torch.clamp(tmin, min=min_near)
    fars = torch.maximum(tmax, nears)
    return nears, fars


def linspace01(T: int, device=None) -> torch.Tensor:
    """linspace(0, 1, T) in f32 as XLA computes it: i * f32(1 / (T - 1)),
    the last point exactly 1 (the compaction thresholds see every ulp)."""
    z = torch.arange(T, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / (T - 1), dtype=torch.float32, device=device)
    z[-1] = 1.0
    return z


def stratified_segment_jitter(z_sel, sample_dist, T: int, K: int,
                              u: torch.Tensor):
    """Spread compacted samples over their local segments: each z is drawn
    as z - w_l + u * (w_l + w_r), w_l / w_r reaching to the midpoints of
    its gaps (sample_dist / 2 at the span ends), each capped at
    sample_dist * T / K. z_sel [N, K] ascending; sample_dist [N, 1];
    u [N, K] uniform in [0, 1)."""
    N = z_sel.shape[0]
    gap_r = torch.cat([z_sel[:, 1:] - z_sel[:, :-1],
                       sample_dist.expand(N, 1)], dim=-1)
    gap_l = torch.cat([sample_dist.expand(N, 1), gap_r[:, :-1]], dim=-1)
    half_cap = sample_dist * (T / K)
    w_l = torch.minimum(0.5 * gap_l, half_cap)
    w_r = torch.minimum(0.5 * gap_r, half_cap)
    return z_sel - w_l + u * (w_l + w_r)


@dataclass
class Renderer:
    """Compositing settings around a field (``RendererSpec``)."""
    field: NVSFField
    bound: float = 1.0
    density_scale: float = 1.0
    min_near: float = 0.01
    min_near_lidar: float = 0.01
    lidar_max_depth: float = 0.81
    active_sensor: bool = False
    num_steps: int = 768
    compute_dtype: torch.dtype = torch.float32
    occ_jitter: bool = True
    occ_delta_clamp: float = 0.0

    def aabb(self, device):
        b = self.bound
        return torch.tensor([-b, -b, -b, b, b, b], dtype=torch.float32,
                            device=device)

    def _occ_delta_cap(self, sample_dist, T, K):
        """clamp * sample_dist, or the legacy 2 * (T / K) * sample_dist."""
        c = self.occ_delta_clamp
        return sample_dist * (c if c > 0 else 2.0 * (T / K))

    def run_occupancy(self, rays_o, rays_d, time, occ: OccupancyGrid,
                      occ_grid, *, num_steps_occ: int,
                      cal_lidar_color=False, perturb=False, generator=None,
                      z_noise: Optional[torch.Tensor] = None,
                      jitter_u: Optional[torch.Tensor] = None,
                      bg_color=None, occ_thresh: float = 0.01,
                      skip_warp=False):
        """T uniform candidates per ray, compacted to the K occupied ones,
        the field evaluated at N x K points and composited.

        With ``perturb``, ``z_noise`` [N, T] and ``jitter_u`` [N, K]
        (uniform in [0, 1)) replace the draws from ``generator``."""
        N = rays_o.shape[0]
        T = self.num_steps
        K = num_steps_occ
        dev = rays_o.device
        aabb = self.aabb(dev)

        if cal_lidar_color:
            nears = torch.full((N, 1), self.min_near_lidar, device=dev)
            fars = torch.full((N, 1), self.lidar_max_depth, device=dev)
        else:
            nears, fars = near_far_from_aabb(rays_o, rays_d, aabb,
                                             self.min_near)
            nears, fars = nears[:, None], fars[:, None]

        z_cand = nears + (fars - nears) * linspace01(T, dev)[None, :]
        sample_dist = (fars - nears) / T
        if perturb:
            if z_noise is None:
                z_noise = torch.rand((N, T), generator=generator, device=dev)
            z_cand = z_cand + (z_noise - 0.5) * sample_dist

        z_vals, valid = occ.compact_samples(occ_grid, rays_o, rays_d, z_cand,
                                            K, occ_thresh)
        if perturb and self.occ_jitter:
            if jitter_u is None:
                jitter_u = torch.rand((N, K), generator=generator, device=dev)
            z_vals = stratified_segment_jitter(z_vals, sample_dist, T, K,
                                               jitter_u)

        xyzs = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
        xyzs = torch.minimum(torch.maximum(xyzs, aabb[:3]), aabb[3:])
        dout = self.field.density(xyzs.reshape(-1, 3), time,
                                  cal_lidar_color=cal_lidar_color,
                                  compute_dtype=self.compute_dtype,
                                  skip_warp=skip_warp)
        sigmas = dout["sigma"].reshape(N, K)

        deltas = torch.cat([z_vals[..., 1:] - z_vals[..., :-1],
                            sample_dist.expand(N, 1)], dim=-1)
        deltas = torch.minimum(deltas.clamp_min(0.0),
                               self._occ_delta_cap(sample_dist, T, K))
        sigmas = torch.where(valid, sigmas, 0.0)

        # LiDAR is an active sensor: light crosses the medium twice
        exponent = 2.0 if self.active_sensor else 1.0
        alphas = 1.0 - torch.exp(-exponent * deltas * self.density_scale
                                 * sigmas)
        trans = torch.cumprod(
            torch.cat([torch.ones((N, 1), device=dev),
                       1.0 - alphas + 1e-15], dim=-1), dim=-1)[:, :-1]
        weights = alphas * trans

        dirs = rays_d[:, None, :].expand(N, K, 3)
        mask = ((weights > 1e-4) & valid).reshape(-1)
        rgbs = self.field.color(xyzs.reshape(-1, 3), dirs.reshape(-1, 3),
                                dout["geo_feat"],
                                cal_lidar_color=cal_lidar_color, mask=mask,
                                compute_dtype=self.compute_dtype)
        rgbs = rgbs.reshape(N, K, -1)

        weights_sum = weights.sum(dim=-1)
        depth = (weights * z_vals).sum(dim=-1)
        image = (weights[..., None] * rgbs).sum(dim=-2)
        if cal_lidar_color:
            return {"depth_lidar": depth, "image_lidar": image,
                    "weights_sum_lidar": weights_sum,
                    "weights": weights, "z_vals": z_vals}
        if bg_color is None:
            bg_color = 1.0
        image = image + (1.0 - weights_sum)[..., None] * bg_color
        return {"depth": depth, "image": image, "weights_sum": weights_sum,
                "weights": weights, "z_vals": z_vals}
