"""Multi-resolution hash-grid encodings (counterpart of
``nvsf_tpu/models/hash_grid.py``).

Tables keep the reference's features-major layout [F, L*T] (all levels'
tables concatenated along columns), so every lookup of an encoding is one
``table_gather`` whose backward is the segment-add kernel. Levels whose dense
grid fits in T entries are indexed densely, finer levels through the
instant-ngp spatial hash. Within a step the query time is a scalar, so the
time-bin lerp and the Lagrange feature-basis blend are folded into the table
before the gather (``folded_table``, ``lagrange_fold_table``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn

from nvsf_torch.lib.constants import device_constant
from nvsf_torch.ops.gather import table_gather

_PRIMES = (1, 2654435761, 805459861, 3674653429)
_LOW32 = 0xFFFFFFFF


def level_resolutions(base_resolution: int, max_resolution: int,
                      n_levels: int):
    """Per-level grid resolutions with tcnn's geometric spacing."""
    if n_levels == 1:
        return [int(base_resolution)]
    s = math.exp2(math.log2(max_resolution / base_resolution) / (n_levels - 1))
    return [int(math.floor(base_resolution * (s ** l)))
            for l in range(n_levels)]


def lagrange_basis(t: torch.Tensor, num_basis: int) -> torch.Tensor:
    """Lagrange basis weights [num_basis] at scalar time t over the nodes
    linspace(0, 1, num_basis)."""
    nodes = [i / (num_basis - 1) for i in range(num_basis)]
    out = []
    for j in range(num_basis):
        basis = torch.ones((), dtype=torch.float32, device=t.device)
        for m in range(num_basis):
            if m != j:
                basis = basis * (t - nodes[m]) / (nodes[j] - nodes[m])
        out.append(basis)
    return torch.stack(out)


def lagrange_fold_table(table: torch.Tensor, t: torch.Tensor,
                        num_basis: int) -> torch.Tensor:
    """[F, C] with rows in ``num_basis`` chunks of F/num_basis -> the
    basis-blended [F/num_basis, C]."""
    F, C = table.shape
    tb = table.reshape(num_basis, F // num_basis, C)
    return torch.tensordot(lagrange_basis(t, num_basis), tb, dims=1)


def _uniform(shape, lo, hi, generator):
    return torch.rand(shape, generator=generator) * (hi - lo) + lo


@dataclass(frozen=True)
class HashEncoding:
    """One multi-resolution hash encoding over D-dim inputs in [0, 1]^D."""
    dim: int = 3
    n_levels: int = 8
    n_features_per_level: int = 4
    log2_hashmap_size: int = 19
    base_resolution: int = 512
    max_resolution: int = 32768

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def resolutions(self):
        return level_resolutions(self.base_resolution, self.max_resolution,
                                 self.n_levels)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def n_cols(self) -> int:
        return self.n_levels * self.table_size

    def init(self, generator=None) -> torch.Tensor:
        """tcnn's U(-1e-4, 1e-4), stored [F, L*T]."""
        return _uniform((self.n_features_per_level, self.n_cols), -1e-4,
                        1e-4, generator)

    def level_cols_weights(self, x: torch.Tensor):
        """x: [N, D] in [0, 1] -> (cols [L*C*N] int32 global column ids,
        wc [L, C, N] multilinear corner weights)."""
        D, L, T = self.dim, self.n_levels, self.table_size
        dev = x.device
        offs = np.stack(np.meshgrid(*([np.arange(2)] * D), indexing="ij"),
                        axis=-1).reshape(-1, D)
        offs = device_constant(tuple(map(tuple, offs.tolist())), torch.int64,
                               dev)                          # [C, D]
        res = device_constant(tuple(self.resolutions), torch.int64, dev)
        dense = device_constant(
            tuple((r + 1) ** D <= T for r in self.resolutions), torch.bool,
            dev)
        level_offs = torch.arange(L, dtype=torch.int64, device=dev) * T

        pos = x.to(torch.float32)[:, None, :] \
            * res.to(torch.float32)[None, :, None]            # [N, L, D]
        c0f = torch.floor(pos)
        w = pos - c0f
        corners = c0f.long()[:, :, None, :] + offs[None, None]  # [N, L, C, D]
        corners = torch.minimum(corners.clamp_min(0),
                                res[None, :, None, None])
        idx_dense = corners[..., 0]
        stride = torch.ones_like(res)
        for d in range(1, D):
            stride = stride * (res + 1)
            idx_dense = idx_dense + corners[..., d] * stride[None, :, None]
        # uint32 wraparound of the reference hash: products are exact in
        # int64 (corner < 2^16, prime < 2^32), so keep their low 32 bits
        h = (corners[..., 0] * _PRIMES[0]) & _LOW32
        for d in range(1, D):
            h = h ^ ((corners[..., d] * _PRIMES[d]) & _LOW32)
        idx_hash = h & (T - 1)
        idx = torch.where(dense[None, :, None], idx_dense, idx_hash)
        cols = idx + level_offs[None, :, None]                # [N, L, C]
        cols = cols.permute(1, 2, 0).reshape(-1).to(torch.int32)

        wt = w.permute(1, 2, 0)                               # [L, D, N]
        wc = None
        for d in range(D):
            wd = torch.where(offs[None, :, d:d + 1] == 1,
                             wt[:, None, d, :], 1.0 - wt[:, None, d, :])
            wc = wd if wc is None else wc * wd                # [L, C, N]
        return cols, wc

    def interp(self, table: torch.Tensor, cols: torch.Tensor,
               wc: torch.Tensor, precision: str = "f32") -> torch.Tensor:
        """Gather + corner-weight reduce: table [F', cols_total] ->
        [N, L*F'] level-major."""
        vals = table_gather(table, cols, precision=precision)
        return _reduce_corners(vals, wc)

    def apply(self, table: torch.Tensor, x: torch.Tensor,
              precision: str = "f32") -> torch.Tensor:
        cols, wc = self.level_cols_weights(x)
        return self.interp(table, cols, wc, precision)


def _reduce_corners(vals: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """vals [F', L*C*N] gathered corners, wc [L, C, N] -> [N, L*F']."""
    L, C, N = wc.shape
    v = vals.reshape(-1, L, C, N)
    feat = (v * wc[None]).sum(dim=2)                          # [F', L, N]
    return feat.permute(2, 1, 0).reshape(N, -1)


@dataclass(frozen=True)
class HashGridT:
    """Time-binned 2D hash grids with the bin lerp and the Lagrange basis
    folded into one [F/B, L*T] table per scalar t."""
    time_resolution: int = 8
    base_resolution: int = 512
    max_resolution: int = 32768
    n_levels: int = 8
    n_features_per_level: int = 4
    log2_hashmap_size: int = 14
    num_basis: int = 4

    @property
    def grid(self) -> HashEncoding:
        return HashEncoding(dim=2, n_levels=self.n_levels,
                            n_features_per_level=self.n_features_per_level,
                            log2_hashmap_size=self.log2_hashmap_size,
                            base_resolution=self.base_resolution,
                            max_resolution=self.max_resolution)

    @property
    def n_output_dims(self) -> int:
        return self.n_levels * self.n_features_per_level // self.num_basis

    def init(self, generator=None) -> torch.Tensor:
        return torch.stack([self.grid.init(generator)
                            for _ in range(self.time_resolution)])

    def folded_table(self, tables: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        """[TR, F, L*T] -> [F/B, L*T] at scalar t."""
        idx = t * (self.time_resolution - 1)
        i1 = torch.floor(idx).long()
        i2 = torch.clamp(i1 + 1, max=self.time_resolution - 1)
        w2 = idx - i1.to(torch.float32)
        # bins are read with clamped indices (a warp time before the first
        # frame is negative), the weight keeps the unclamped bin, as JAX's
        # dynamic indexing does
        last = self.time_resolution - 1
        t1 = tables.index_select(0, i1.clamp(0, last).reshape(1))[0]
        t2 = tables.index_select(0, i2.clamp(0, last).reshape(1))[0]
        blended = (1.0 - w2) * t1 + w2 * t2
        return lagrange_fold_table(blended, t, self.num_basis)


class HashGrid4D(nn.Module):
    """Static 3D hash + three time-binned 2D planes (xyt, xzt, yzt)."""

    PLANE_KEYS = ("dyn_xyt", "dyn_xzt", "dyn_yzt")
    PLANE_AXES = ((0, 1), (0, 2), (1, 2))

    def __init__(self, base_resolution=512, max_resolution=32768,
                 time_resolution=8, n_levels=8, n_features_per_level=4,
                 log2_hashmap_size=19,
                 hash_size_dynamic: Tuple[int, int, int] = (15, 13, 13),
                 generator=None):
        super().__init__()
        self.static_grid = HashEncoding(
            dim=3, n_levels=n_levels,
            n_features_per_level=n_features_per_level,
            log2_hashmap_size=log2_hashmap_size,
            base_resolution=base_resolution, max_resolution=max_resolution)
        self.dynamic_grids = tuple(
            HashGridT(time_resolution=time_resolution,
                      base_resolution=base_resolution,
                      max_resolution=max_resolution, n_levels=n_levels,
                      n_features_per_level=n_features_per_level,
                      log2_hashmap_size=hash_size_dynamic[i])
            for i in range(3))
        self.static = nn.Parameter(self.static_grid.init(generator))
        for key, g in zip(self.PLANE_KEYS, self.dynamic_grids):
            setattr(self, key, nn.Parameter(g.init(generator)))

    @property
    def n_output_dims_static(self) -> int:
        return self.static_grid.n_output_dims

    @property
    def n_output_dims_dynamic(self) -> int:
        return self.dynamic_grids[0].n_output_dims * 3

    def apply_static(self, x, precision="f32"):
        return self.static_grid.apply(self.static, x, precision)

    def _dynamic_cols_weights(self, x):
        cols_all, wcs, offset = [], [], 0
        for g, (a, b) in zip(self.dynamic_grids, self.PLANE_AXES):
            cols, wc = g.grid.level_cols_weights(
                torch.stack((x[:, a], x[:, b]), dim=-1))
            cols_all.append(cols + offset)
            wcs.append(wc)
            offset += g.grid.n_cols
        return torch.cat(cols_all), wcs

    def _dynamic_folded(self, t):
        return torch.cat([g.folded_table(getattr(self, k), t)
                          for g, k in zip(self.dynamic_grids,
                                          self.PLANE_KEYS)], dim=1)

    @staticmethod
    def _assemble(vals, wcs):
        outs, p = [], 0
        for wc in wcs:
            n = wc.numel()
            outs.append(_reduce_corners(vals[:, p:p + n], wc))
            p += n
        return torch.cat(outs, dim=-1)

    def apply_dynamic(self, x, t, precision="f32"):
        """x: [N, 3] in [0,1]; scalar t -> [N, n_output_dims_dynamic]."""
        cols, wcs = self._dynamic_cols_weights(x)
        table = self._dynamic_folded(t)
        return self._assemble(table_gather(table, cols, precision=precision),
                              wcs)

    def apply_dynamic_fused3(self, x, x1, x2, t, t1, t2, precision="f32"):
        """The t-query and both temporal-warp queries in one gather. Only the
        t-query carries gradient; the warp queries' positions, folded tables
        and gathered values are detached (the reference's no_grad
        re-queries)."""
        return HashGrid4D.apply_dynamic_fused3_joint(
            [self], [(x, x1, x2)], t, t1, t2, precision)[0]

    # ------------------------------------------------------------------
    # several branches (LiDAR, camera) in one gather per encoder family
    # ------------------------------------------------------------------
    @staticmethod
    def apply_static_joint(grids, xs, precision="f32"):
        """``apply_static`` of each grid in ``grids`` at its points in
        ``xs``, in one gather over the branches' static tables laid side
        by side, branch ``bi``'s columns offset by ``bi * n_cols``; every
        branch's table takes its gradient from the one segment-add of that
        gather. Returns one [N_i, L*F] array per branch
        (``nvsf_tpu/models/hash_grid.py:321-348``)."""
        enc = grids[0].static_grid
        cols_all, wcs = [], []
        for bi, x in enumerate(xs):
            cols, wc = enc.level_cols_weights(x)
            cols_all.append(cols + bi * enc.n_cols)
            wcs.append(wc)
        table = torch.cat([g.static for g in grids], dim=1)
        vals = table_gather(table, torch.cat(cols_all), precision=precision)
        outs, p = [], 0
        for wc in wcs:
            n = wc.numel()
            outs.append(_reduce_corners(vals[:, p:p + n], wc))
            p += n
        return outs

    @staticmethod
    def apply_dynamic_fused3_joint(grids, xs_list, t, t1, t2,
                                   precision="f32"):
        """``apply_dynamic_fused3`` of several branches in one gather
        (``nvsf_tpu/models/hash_grid.py:429-481``). ``xs_list`` holds each
        branch's (x, x1, x2). The rows run [b0_t, b1_t, ..., b0_t1, b0_t2,
        b1_t1, b1_t2, ...]: the gradient-carrying t-queries form the row
        prefix (``n_grad``) and their folded tables the column prefix
        (``B * S``), so one segment-add covers every branch; the warp
        queries stay detached. Returns one (feat_t, feat_t1, feat_t2) per
        branch."""
        B = len(grids)
        grad_cols, grad_tbls, grad_wcs = [], [], []
        warp_cols, warp_tbls, warp_wcs = [], [], []
        for bi, (g, (x, x1, x2)) in enumerate(zip(grids, xs_list)):
            cols0, wcs0 = g._dynamic_cols_weights(x)
            tb0 = g._dynamic_folded(t)
            S = tb0.shape[1]
            grad_cols.append(cols0 + bi * S)
            grad_tbls.append(tb0)
            grad_wcs.append(wcs0)
            with torch.no_grad():
                for xw, tw in ((x1, t1), (x2, t2)):
                    cols, wcs = g._dynamic_cols_weights(xw.detach())
                    warp_cols.append(cols)
                    warp_tbls.append(g._dynamic_folded(tw))
                    warp_wcs.append(wcs)
        # the warp tables sit after the B gradient tables
        warp_cols = [c + (B + wi) * S for wi, c in enumerate(warp_cols)]
        n_grad = sum(c.shape[0] for c in grad_cols)
        vals = table_gather(torch.cat(grad_tbls + warp_tbls, dim=1),
                            torch.cat(grad_cols + warp_cols), n_grad=n_grad,
                            grad_cols_T=B * S, precision=precision)
        outs, p = [], 0
        for wcs in grad_wcs + warp_wcs:
            n = sum(wc.numel() for wc in wcs)
            v = vals[:, p:p + n]
            outs.append(HashGrid4D._assemble(v if p < n_grad else v.detach(),
                                             wcs))
            p += n
        return [(outs[bi], outs[B + 2 * bi], outs[B + 2 * bi + 1])
                for bi in range(B)]
