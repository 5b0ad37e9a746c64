"""The composed NVSF neural field (counterpart of
``nvsf_tpu/models/field.py``): separate LiDAR / camera encoder branches
(K-planes + 4D hash grid), a shared flow field and sigma net, LiDAR
intensity and ray-drop heads, a camera color head.

The ±1-frame temporal warp is always computed and blended with boundary
masks, as in the JAX package. The warped hash re-queries carry no gradient
(the reference's ``torch.no_grad``); the flow field learns through the
warped K-planes only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from nvsf_torch.models.encodings import (FREQ_DEG12_DIM, SH_DEG4_DIM,
                                         frequency_encode, sh_encode_deg4)
from nvsf_torch.models.flow import FlowField
from nvsf_torch.models.hash_grid import HashGrid4D
from nvsf_torch.models.mlp import MLP
from nvsf_torch.models.planes import Planes4D
from nvsf_torch.train.profiler import span, traced


class _TruncExp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with its gradient taken at clamp(x, -15, 15)."""
    return _TruncExp.apply(x)


def _blend(has_next, has_prev, q_d, q_1, q_2):
    """The ±1-frame blend 0.5 q + 0.25 (q_next + q_prev), a missing
    neighbour frame's query replaced by q."""
    q_1 = torch.where(has_next, q_1, q_d)
    q_2 = torch.where(has_prev, q_2, q_d)
    return 0.5 * q_d + 0.25 * (q_1 + q_2)


@dataclass(frozen=True)
class FieldSpec:
    """Hyperparameters of the field; same names and defaults as
    ``nvsf_tpu.models.field.NVSFFieldSpec``."""
    min_resolution: int = 32
    n_levels_plane: int = 4
    n_features_per_level_plane: int = 8
    base_resolution: int = 512
    max_resolution: int = 32768
    time_resolution: int = 8
    n_levels_hash: int = 8
    n_features_per_level_hash: int = 4
    log2_hashmap_size: int = 19
    hash_size_dynamic: Tuple[int, int, int] = (15, 13, 13)
    num_layers_flow: int = 3
    hidden_dim_flow: int = 64
    flow_n_levels: int = 16
    flow_n_features_per_level: int = 8
    flow_base_resolution: int = 32
    flow_max_resolution: int = 8192
    flow_log2_hashmap_size: int = 18
    num_layers_sigma: int = 2
    hidden_dim_sigma: int = 64
    geo_feat_dim: int = 15
    num_layers_lidar: int = 3
    hidden_dim_lidar: int = 64
    num_layers_color: int = 3
    hidden_dim_color: int = 64
    out_color_dim: int = 3
    out_lidar_color_dim: int = 2
    num_frames: int = 51
    bound: float = 1.0


SLOW_MODULES = ("flow", "intensity_net", "raydrop_net")


class NVSFField(nn.Module):
    """Parameter names follow the JAX params tree (``bridge.py``)."""

    def __init__(self, spec: FieldSpec = FieldSpec(), generator=None,
                 table_grad_precision: str = "f32"):
        super().__init__()
        self.spec = spec
        # rounding of hash-table gradient updates before their f32 sum:
        # "bf16" for bf16 training steps, as the TPU kernel rounds them
        self.table_grad_precision = table_grad_precision
        s = spec

        def planes():
            return Planes4D(
                output_dim=s.n_features_per_level_plane,
                resolution=(s.min_resolution,) * 3 + (s.time_resolution,),
                multiscale_res=tuple(2 ** n for n in range(s.n_levels_plane)),
                generator=generator)

        def hashes():
            return HashGrid4D(
                base_resolution=s.base_resolution,
                max_resolution=s.max_resolution,
                time_resolution=s.time_resolution, n_levels=s.n_levels_hash,
                n_features_per_level=s.n_features_per_level_hash,
                log2_hashmap_size=s.log2_hashmap_size,
                hash_size_dynamic=tuple(s.hash_size_dynamic),
                generator=generator)

        self.planes_lidar = planes()
        self.hash_lidar = hashes()
        self.planes_camera = planes()
        self.hash_camera = hashes()
        self.flow = FlowField(
            num_layers=s.num_layers_flow, hidden_dim=s.hidden_dim_flow,
            n_levels=s.flow_n_levels,
            n_features_per_level=s.flow_n_features_per_level,
            base_resolution=s.flow_base_resolution,
            max_resolution=s.flow_max_resolution,
            log2_hashmap_size=s.flow_log2_hashmap_size, generator=generator)
        feature_dim = (self.planes_lidar.n_output_dims
                       + self.hash_lidar.n_output_dims_static
                       + self.hash_lidar.n_output_dims_dynamic)
        self.sigma_net = MLP(feature_dim, s.hidden_dim_sigma,
                             1 + s.geo_feat_dim, s.num_layers_sigma,
                             generator=generator)
        self.intensity_net = MLP(FREQ_DEG12_DIM + s.geo_feat_dim,
                                 s.hidden_dim_lidar, 1, s.num_layers_lidar,
                                 generator=generator)
        self.raydrop_net = MLP(FREQ_DEG12_DIM + s.geo_feat_dim,
                               s.hidden_dim_lidar, 1, s.num_layers_lidar,
                               generator=generator)
        self.color_net = MLP(SH_DEG4_DIM + s.geo_feat_dim,
                             s.hidden_dim_color, s.out_color_dim,
                             s.num_layers_color, generator=generator)

    def lr_groups(self):
        """(base, slow) parameter lists: flow / intensity / raydrop train at
        0.1x the learning rate (``network_dynamic.py:335-357``)."""
        base, slow = [], []
        for name, p in self.named_parameters():
            (slow if name.split(".")[0] in SLOW_MODULES else base).append(p)
        return base, slow

    # ------------------------------------------------------------------
    def _scalar_time(self, t, like):
        return torch.as_tensor(t, dtype=torch.float32,
                               device=like.device).reshape(())

    def flow_at(self, x, t, compute_dtype=torch.float32):
        """x: [N, 3] in [-bound, bound]; scalar t -> forward/backward flow."""
        b = self.spec.bound
        xn = (x + b) / (2 * b)
        t = self._scalar_time(t, x)
        xt = torch.cat([xn, t.expand(xn.shape[0], 1)], dim=-1)
        f = self.flow(xt, compute_dtype, self.table_grad_precision)
        return {"flow_forward": f[:, :3], "flow_backward": f[:, 3:]}

    def density(self, x, t, cal_lidar_color=False,
                compute_dtype=torch.float32, skip_warp=False):
        """x: [N, 3] in [-bound, bound]; scalar t in [0, 1] ->
        {"sigma": [N], "geo_feat": [N, geo_feat_dim]}.

        ``skip_warp`` drops the flow and the ±1-frame blend: the cheaper
        query of the occupancy refresh."""
        branch = "lidar" if cal_lidar_color else "camera"
        hashes = getattr(self, f"hash_{branch}")
        planes = getattr(self, f"planes_{branch}")
        prec = self.table_grad_precision
        nf = self.spec.num_frames
        b = self.spec.bound
        dev = x.device

        xn = (x + b) / (2 * b)
        t = self._scalar_time(t, x)
        frame_idx = torch.floor(t * (nf - 1))
        N = xn.shape[0]
        xt = torch.cat([xn, t.expand(N, 1)], dim=-1)

        if skip_warp:
            with span("encode.hash", dev, backward=True) as s:
                hash_s, hash_d = s.out((hashes.apply_static(xn, prec),
                                        hashes.apply_dynamic(xn, t, prec)))
            with span("encode.planes", dev, backward=True) as s:
                plane_s, plane_d = s.out((planes.apply_static(xt),
                                          planes.apply_dynamic(xt)))
        else:
            flow = self.flow(xt, compute_dtype, prec)
            with span("encode.hash", dev, backward=True) as s:
                # warp times are (frame_idx ± 1) / num_frames, as upstream
                t1 = (frame_idx + 1) / nf
                t2 = (frame_idx - 1) / nf
                x1 = xn + flow[:, :3]
                x2 = xn + flow[:, 3:]
                has_next = frame_idx < nf - 1
                has_prev = frame_idx > 0
                hash_s = hashes.apply_static(xn, prec)
                hash_d = _blend(has_next, has_prev,
                                *hashes.apply_dynamic_fused3(
                                    xn, x1, x2, t, t1, t2, prec))
                hash_s, hash_d = s.out((hash_s, hash_d))
            with span("encode.planes", dev, backward=True) as s:
                ts3 = torch.stack([t, t1, t2])
                xts = torch.cat([torch.stack([xn, x1, x2]),
                                 ts3[:, None, None].expand(3, N, 1)], dim=-1)
                plane_s = planes.apply_static(xt)
                plane_d = _blend(has_next, has_prev,
                                 *planes.apply_dynamic_multi(xts))
                plane_s, plane_d = s.out((plane_s, plane_d))

        with span("mlp", dev, backward=True) as s:
            h = self.sigma_net(torch.cat([plane_s, plane_d, hash_s, hash_d],
                                         -1), compute_dtype).to(torch.float32)
            return s.out({"sigma": trunc_exp(h[..., 0]),
                          "geo_feat": h[..., 1:]})

    def density_joint(self, x_l, x_c, t, compute_dtype=torch.float32,
                      x_flow_extra=None):
        """``density`` of the LiDAR points ``x_l`` and the camera points
        ``x_c`` at one scalar t, with each encoder family run once for
        both branches (``nvsf_tpu/models/field.py:270-378``): one static
        hash lookup, one dynamic hash lookup of both branches' t-queries
        and one of their warp queries, one K-planes sampler call for the
        static planes and one for all six dynamic queries, one flow batch
        (both branches and the optional ``x_flow_extra`` [E, 3] points of
        the flow loss) and one sigma-net batch.

        Returns {"sigma_l", "geo_feat_l", "sigma_c", "geo_feat_c"[,
        "flow_extra"]}."""
        hashes = [self.hash_lidar, self.hash_camera]
        planes = [self.planes_lidar, self.planes_camera]
        prec = self.table_grad_precision
        nf = self.spec.num_frames
        b = self.spec.bound
        dev = x_l.device
        N_l, N_c = x_l.shape[0], x_c.shape[0]
        xn_l = (x_l + b) / (2 * b)
        xn_c = (x_c + b) / (2 * b)
        t = self._scalar_time(t, x_l)
        frame_idx = torch.floor(t * (nf - 1))

        xn_all = [xn_l, xn_c]
        if x_flow_extra is not None:
            xn_all.append((x_flow_extra + b) / (2 * b))
        xn_all = torch.cat(xn_all)
        xt_all = torch.cat([xn_all, t.expand(xn_all.shape[0], 1)], dim=-1)
        flow_all = self.flow(xt_all, compute_dtype, prec)
        flow_l, flow_c = flow_all[:N_l], flow_all[N_l:N_l + N_c]

        # warp times are (frame_idx ± 1) / num_frames, as upstream
        t1 = (frame_idx + 1) / nf
        t2 = (frame_idx - 1) / nf
        has_next = frame_idx < nf - 1
        has_prev = frame_idx > 0

        def blend(q):
            return _blend(has_next, has_prev, *q)

        with span("encode.hash", dev, backward=True) as s:
            qs = [(xn, xn + fl[:, :3], xn + fl[:, 3:])
                  for xn, fl in ((xn_l, flow_l), (xn_c, flow_c))]
            hash_s_l, hash_s_c = HashGrid4D.apply_static_joint(
                hashes, [xn_l, xn_c], prec)
            hq_l, hq_c = HashGrid4D.apply_dynamic_fused3_joint(
                hashes, qs, t, t1, t2, prec)
            hash_s_l, hash_s_c, hash_d_l, hash_d_c = s.out(
                (hash_s_l, hash_s_c, blend(hq_l), blend(hq_c)))
        with span("encode.planes", dev, backward=True) as s:
            plane_s_l, plane_s_c = Planes4D.apply_static_joint(
                planes, [xt_all[:N_l], xt_all[N_l:N_l + N_c]])
            ts3 = torch.stack([t, t1, t2])
            pq_l, pq_c = Planes4D.apply_dynamic_multi_branches(planes, [
                torch.cat([torch.stack(q), ts3[:, None, None].expand(
                    3, q[0].shape[0], 1)], dim=-1) for q in qs])
            plane_s_l, plane_s_c, plane_d_l, plane_d_c = s.out(
                (plane_s_l, plane_s_c, blend(pq_l), blend(pq_c)))

        with span("mlp", dev, backward=True) as s:
            h = self.sigma_net(torch.cat([
                torch.cat([plane_s_l, plane_d_l, hash_s_l, hash_d_l], -1),
                torch.cat([plane_s_c, plane_d_c, hash_s_c, hash_d_c], -1)]),
                compute_dtype).to(torch.float32)
            sigma = trunc_exp(h[..., 0])
            out = s.out({"sigma_l": sigma[:N_l], "geo_feat_l": h[:N_l, 1:],
                         "sigma_c": sigma[N_l:], "geo_feat_c": h[N_l:, 1:]})
        if x_flow_extra is not None:
            fe = flow_all[N_l + N_c:]
            out["flow_extra"] = {"flow_forward": fe[:, :3],
                                 "flow_backward": fe[:, 3:]}
        return out

    @traced("mlp")
    def color(self, x, d, geo_feat, cal_lidar_color=False, mask=None,
              compute_dtype=torch.float32):
        """d: [N, 3] view dirs in [-1, 1] -> LiDAR [N, 2] (raydrop,
        intensity) or camera [N, 3] rgb, after a sigmoid."""
        dn = (d + 1.0) / 2.0
        if cal_lidar_color:
            inp = torch.cat([frequency_encode(dn, 12),
                             geo_feat.to(torch.float32)], -1)
            h = torch.cat([self.raydrop_net(inp, compute_dtype),
                           self.intensity_net(inp, compute_dtype)], -1)
        else:
            inp = torch.cat([sh_encode_deg4(dn),
                             geo_feat.to(torch.float32)], -1)
            h = self.color_net(inp, compute_dtype)
        h = torch.sigmoid(h.to(torch.float32))
        if mask is not None:
            h = torch.where(mask[:, None], h, 0.0)
        return h
