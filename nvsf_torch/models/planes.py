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


def bilinear_sample_fmajor(plane_flat, H, W, u, v, offset=0):
    """Sample a [F, H*W] plane at (u -> W axis, v -> H axis) with
    align_corners and border clamping -> [F, N]. ``offset`` (per point)
    shifts the flat columns, for planes laid side by side."""
    x0, x1, wx = _lerp_coords(u, W)
    y0, y1, wy = _lerp_coords(v, H)

    def gather(yy, xx):
        return plane_flat.index_select(1, yy * W + xx + offset)

    return (gather(y0, x0) * ((1 - wx) * (1 - wy))[None]
            + gather(y0, x1) * (wx * (1 - wy))[None]
            + gather(y1, x0) * ((1 - wx) * wy)[None]
            + gather(y1, x1) * (wx * wy)[None])


def _cat(ts, dim=0):
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim=dim)


def _pad_to(a, n):
    """Zero-pad the last axis of ``a`` to length ``n``."""
    return a if a.shape[-1] == n else Fn.pad(a, (0, n - a.shape[-1]))


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
        return Planes4D.apply_static_joint([self], [xt])[0]

    def apply_dynamic(self, xt):
        return self.apply_dynamic_multi(xt[None])[0]

    def apply_dynamic_multi(self, xts):
        """xts: [Q, N, 4] (one scalar time per query) -> [Q, N, S*F].

        The time lerp of each (x/y/z, t) plane folds into its table rows, so
        each query samples 1-D tables of width <= DYN_W_PAD with two lerp
        corners. Gradients reach the tables and, through the lerp weights,
        the query positions (the flow field)."""
        return Planes4D.apply_dynamic_multi_branches([self], [xts])[0]

    def _coarse_static(self):
        """Scales whose static planes all fit in MULTIHOT_MAX_W slots."""
        return [si for si in range(len(self.multiscale_res))
                if max(self.plane_hw(si, ci)[0] * self.plane_hw(si, ci)[1]
                       for ci in STATIC) <= self.MULTIHOT_MAX_W]

    @staticmethod
    def apply_static_joint(planes_list, xt_list):
        """``apply_static`` of several branches: the coarse scales of every
        branch in one ``multihot_sample`` (segments ordered branch, scale,
        plane; each branch's points padded to the longest with zero
        weights), each fine-scale plane in one gather over the branches'
        tables laid side by side (``nvsf_tpu/models/planes.py:235-320``).
        Returns one [N_i, S*F] array per branch."""
        pl = planes_list[0]
        B, S, F = len(planes_list), len(pl.multiscale_res), pl.output_dim
        ns = [xt.shape[0] for xt in xt_list]
        Np = max(ns)
        coarse = pl._coarse_static()
        per_branch = [dict() for _ in range(B)]
        if coarse:
            tables, cols, ws = [], [], []
            for planes, xt in zip(planes_list, xt_list):
                for si in coarse:
                    for ci in STATIC:
                        a, b = COO_COMBS[ci]
                        H, W = pl.plane_hw(si, ci)
                        tables.append(Fn.pad(planes[si][ci],
                                             (0, pl.MULTIHOT_MAX_W - H * W)))
                        c4, w4 = bilinear_cols_weights(xt[:, a], xt[:, b],
                                                       H, W)
                        cols.append(_pad_to(c4, Np))
                        ws.append(_pad_to(w4, Np))
            SP = len(tables)
            feats = multihot_sample(
                torch.cat(tables, dim=1),
                torch.stack(cols).reshape(1, SP, 4, Np),
                torch.stack(ws).reshape(1, SP, 4, Np),
                pl.MULTIHOT_MAX_W, need_dw=False)
            feats = feats[0].reshape(B, len(coarse), len(STATIC), F, Np)
            feats = feats[:, :, 0] * feats[:, :, 1] * feats[:, :, 2]
            for bi in range(B):
                for k, si in enumerate(coarse):
                    per_branch[bi][si] = feats[bi, k, :, :ns[bi]]
        for si in range(S):
            if si in coarse:
                continue
            for ci in STATIC:
                a, b = COO_COMBS[ci]
                H, W = pl.plane_hw(si, ci)
                tbl = _cat([planes[si][ci] for planes in planes_list],
                           dim=1)                           # [F, B*H*W]
                off = 0 if B == 1 else torch.cat(
                    [torch.full((n,), bi * H * W, dtype=torch.long,
                                device=tbl.device)
                     for bi, n in enumerate(ns)])
                f = bilinear_sample_fmajor(
                    tbl, H, W, _cat([xt[:, a] for xt in xt_list]),
                    _cat([xt[:, b] for xt in xt_list]), off)  # [F, sum n]
                for bi, fb in enumerate(f.split(ns, dim=1)):
                    cur = per_branch[bi].get(si)
                    per_branch[bi][si] = fb if cur is None else cur * fb
        return [torch.cat([d[si] for si in range(S)], dim=0).t()
                for d in per_branch]

    @staticmethod
    def apply_dynamic_multi_branches(planes_list, xts_list):
        """``apply_dynamic_multi`` of several branches (one [Q_i, N_i, 4]
        query stack each) in one ``multihot_sample`` over all sum(Q_i)
        queries, each branch's points padded to the longest with zero
        weights (``nvsf_tpu/models/planes.py:342-413``). Returns one
        [Q_i, N_i, S*F] array per branch."""
        pl = planes_list[0]
        F, S, W_PAD = pl.output_dim, len(pl.multiscale_res), pl.DYN_W_PAD
        qs = [xts.shape[0] for xts in xts_list]
        ns = [xts.shape[1] for xts in xts_list]
        Np = max(ns)
        folded, cols, ws = [], [], []
        for planes, xts in zip(planes_list, xts_list):
            for q in range(xts.shape[0]):
                t = xts[q, 0, 3]
                for si in range(S):
                    for ci in DYNAMIC:
                        a, _b = COO_COMBS[ci]
                        H, W = pl.plane_hw(si, ci)
                        if W > W_PAD:
                            raise ValueError(
                                f"dynamic plane (scale {si}, plane {ci}) "
                                f"width {W} exceeds DYN_W_PAD={W_PAD}")
                        y0, y1, wy = _lerp_coords(t, H)
                        tbl = planes[si][ci].reshape(F, H, W)
                        r0 = tbl.index_select(1, y0.reshape(1))[:, 0]
                        r1 = tbl.index_select(1, y1.reshape(1))[:, 0]
                        folded.append(Fn.pad((1.0 - wy) * r0 + wy * r1,
                                             (0, W_PAD - W)))
                        x0, x1, wx = _lerp_coords(xts[q, :, a], W)
                        cols.append(_pad_to(torch.stack([x0, x1]), Np))
                        ws.append(_pad_to(torch.stack([1.0 - wx, wx]), Np))
        Qt, SP = sum(qs), S * len(DYNAMIC)
        feats = multihot_sample(
            torch.cat(folded, dim=1),
            torch.stack(cols).reshape(Qt, SP, 2, Np).to(torch.int32),
            torch.stack(ws).reshape(Qt, SP, 2, Np), W_PAD)
        feats = feats.reshape(Qt, S, len(DYNAMIC), F, Np)
        feats = feats[:, :, 0] * feats[:, :, 1] * feats[:, :, 2]
        feats = feats.reshape(Qt, S * F, Np).transpose(1, 2)
        return [f[:, :n] for f, n in zip(feats.split(qs), ns)]
