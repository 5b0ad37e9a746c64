"""K-planes (Planes4D) factorization of the (x, y, z, t) volume (counterpart
of ``nvsf_tpu/models/planes.py``).

Six planes per scale, four scales; bilinear lookups with align_corners and
border clamping; the static group (xy, xz, yz) and the dynamic group (xt,
yt, zt) are each reduced by product, features concatenated across scales.
Coarse static scales (tables of at most ``MULTIHOT_MAX_W`` slots) and all
dynamic queries go through ``multihot_sample`` (its CUDA kernels on the
GPU); fine static scales use plain indexed gathers.
"""

from __future__ import annotations

import itertools

import torch
import torch.nn as nn
import torch.nn.functional as Fn

from nvsf_torch.ops.multihot import multihot_sample

COO_COMBS = tuple(itertools.combinations(range(4), 2))
STATIC = tuple(ci for ci, cc in enumerate(COO_COMBS) if 3 not in cc)
DYNAMIC = tuple(ci for ci, cc in enumerate(COO_COMBS) if 3 in cc)


def _lerp_coords(u, n):
    """Continuous coordinate u in [0, 1] over n cells -> (i0, i1, w)."""
    x = torch.clamp(u, 0.0, 1.0) * (n - 1)
    x0 = torch.floor(x).long()
    x1 = torch.clamp(x0 + 1, max=n - 1)
    return x0, x1, x - x0.to(x.dtype)


def bilinear_sample_fmajor(plane_flat, H, W, u, v):
    """Sample a [F, H*W] plane at (u -> W axis, v -> H axis) with
    align_corners and border clamping -> [F, N]."""
    x0, x1, wx = _lerp_coords(u, W)
    y0, y1, wy = _lerp_coords(v, H)

    def gather(yy, xx):
        return plane_flat.index_select(1, yy * W + xx)

    return (gather(y0, x0) * ((1 - wx) * (1 - wy))[None]
            + gather(y0, x1) * (wx * (1 - wy))[None]
            + gather(y1, x0) * ((1 - wx) * wy)[None]
            + gather(y1, x1) * (wx * wy)[None])


def bilinear_cols_weights(u, v, H, W):
    """Flat bilinear corner columns and weights: ([4, N] int32, [4, N])."""
    x0, x1, wx = _lerp_coords(u, W)
    y0, y1, wy = _lerp_coords(v, H)
    cols = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1])
    wts = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy),
                       (1 - wx) * wy, wx * wy])
    return cols.to(torch.int32), wts


class Planes4D(nn.ModuleList):
    """[scale][plane] parameters of flat shape [F, res_b * res_a]: time
    planes start at ones, spatial planes U(0.1, 0.5)."""

    # largest per-segment table the multihot sampler takes for the static
    # planes, and the uniform width of a folded dynamic plane
    MULTIHOT_MAX_W = 4096
    DYN_W_PAD = 256

    def __init__(self, output_dim=8, resolution=(32, 32, 32, 8),
                 multiscale_res=(1, 2, 4, 8), generator=None):
        super().__init__()
        self.output_dim = output_dim
        self.resolution = tuple(resolution)
        self.multiscale_res = tuple(multiscale_res)
        for si in range(len(self.multiscale_res)):
            planes = []
            for ci, (a, b) in enumerate(COO_COMBS):
                H, W = self.plane_hw(si, ci)
                if 3 in (a, b):
                    p = torch.ones((output_dim, H * W))
                else:
                    p = torch.rand((output_dim, H * W),
                                   generator=generator) * 0.4 + 0.1
                planes.append(nn.Parameter(p))
            self.append(nn.ParameterList(planes))

    @property
    def n_output_dims(self) -> int:
        return self.output_dim * len(self.multiscale_res) * 2

    def plane_hw(self, si: int, ci: int):
        s = self.multiscale_res[si]
        reso = [r * s for r in self.resolution[:3]] + [self.resolution[3]]
        a, b = COO_COMBS[ci]
        return reso[b], reso[a]

    def apply_static(self, xt):
        """xt: [N, 4] in [0,1] -> [N, S*F] static features."""
        S = len(self.multiscale_res)
        F = self.output_dim
        N = xt.shape[0]
        coarse = [si for si in range(S)
                  if max(self.plane_hw(si, ci)[0] * self.plane_hw(si, ci)[1]
                         for ci in STATIC) <= self.MULTIHOT_MAX_W]
        per_scale = {}
        if coarse:
            tables, cols, ws = [], [], []
            for si in coarse:
                for ci in STATIC:
                    a, b = COO_COMBS[ci]
                    H, W = self.plane_hw(si, ci)
                    tables.append(Fn.pad(self[si][ci],
                                         (0, self.MULTIHOT_MAX_W - H * W)))
                    c4, w4 = bilinear_cols_weights(xt[:, a], xt[:, b], H, W)
                    cols.append(c4)
                    ws.append(w4)
            SP = len(tables)
            feats = multihot_sample(
                torch.cat(tables, dim=1),
                torch.stack(cols).reshape(1, SP, 4, N),
                torch.stack(ws).reshape(1, SP, 4, N),
                self.MULTIHOT_MAX_W, need_dw=False)
            feats = feats[0].reshape(len(coarse), len(STATIC), F, N)
            feats = feats[:, 0] * feats[:, 1] * feats[:, 2]
            for k, si in enumerate(coarse):
                per_scale[si] = feats[k]
        for si in range(S):
            if si in per_scale:
                continue
            feat = None
            for ci in STATIC:
                a, b = COO_COMBS[ci]
                H, W = self.plane_hw(si, ci)
                f = bilinear_sample_fmajor(self[si][ci], H, W, xt[:, a],
                                           xt[:, b])
                feat = f if feat is None else feat * f
            per_scale[si] = feat
        return torch.cat([per_scale[si] for si in range(S)], dim=0).t()

    def apply_dynamic(self, xt):
        return self.apply_dynamic_multi(xt[None])[0]

    def apply_dynamic_multi(self, xts):
        """xts: [Q, N, 4] (one scalar time per query) -> [Q, N, S*F].

        The time lerp of each (x/y/z, t) plane folds into its table rows, so
        each query samples 1-D tables of width <= DYN_W_PAD with two lerp
        corners. Gradients reach the tables and, through the lerp weights,
        the query positions (the flow field)."""
        Q, N, _ = xts.shape
        F = self.output_dim
        S = len(self.multiscale_res)
        W_PAD = self.DYN_W_PAD
        folded, cols, ws = [], [], []
        for q in range(Q):
            t = xts[q, 0, 3]
            for si in range(S):
                for ci in DYNAMIC:
                    a, _b = COO_COMBS[ci]
                    H, W = self.plane_hw(si, ci)
                    if W > W_PAD:
                        raise ValueError(
                            f"dynamic plane (scale {si}, plane {ci}) width "
                            f"{W} exceeds DYN_W_PAD={W_PAD}")
                    y0, y1, wy = _lerp_coords(t, H)
                    tbl = self[si][ci].reshape(F, H, W)
                    r0 = tbl.index_select(1, y0.reshape(1))[:, 0]
                    r1 = tbl.index_select(1, y1.reshape(1))[:, 0]
                    folded.append(Fn.pad((1.0 - wy) * r0 + wy * r1,
                                         (0, W_PAD - W)))
                    x0, x1, wx = _lerp_coords(xts[q, :, a], W)
                    cols.append(torch.stack([x0, x1]))
                    ws.append(torch.stack([1.0 - wx, wx]))
        SP = S * len(DYNAMIC)
        feats = multihot_sample(
            torch.cat(folded, dim=1),
            torch.stack(cols).reshape(Q, SP, 2, N).to(torch.int32),
            torch.stack(ws).reshape(Q, SP, 2, N), W_PAD)
        feats = feats.reshape(Q, S, len(DYNAMIC), F, N)
        feats = feats[:, :, 0] * feats[:, :, 1] * feats[:, :, 2]
        return feats.reshape(Q, S * F, N).transpose(1, 2)
