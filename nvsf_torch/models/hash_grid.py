"""Multi-resolution hash-grid encodings (counterpart of
``nvsf_tpu/models/hash_grid.py``).

Tables keep the reference's features-major layout [F, L*T] (all levels'
tables concatenated along columns). Levels whose dense grid fits in T
entries are indexed densely, finer levels through the instant-ngp spatial
hash. Every lookup goes through ``ops/hash_lookup.py::hash_lookup``,
which takes [slots, F] views: ``param.t()`` of a table. Within a step the
query time is a scalar, so the time-bin lerp and the Lagrange
feature-basis blend are folded into the table before the lookup
(``blended_table``, ``lagrange_fold_table``), which writes the row-major
[L*T, F'] table.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn as nn

from nvsf_torch.lib.constants import device_constant
from nvsf_torch.ops.hash_lookup import (Plane, Query, hash_lookup,
                                        level_cols_weights)


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
    basis-blended table, row-major [C, F/num_basis]: one product of the
    transposed table with the basis laid on an identity (PERF.md: on the
    card, with its backward, twice as fast as a contraction and a copy for
    the shipped flow table, within 10 % of them for the others)."""
    F, C = table.shape
    Fb = F // num_basis
    eye = device_constant(tuple(tuple(float(i == j) for j in range(Fb))
                                for i in range(Fb)), torch.float32,
                          table.device)
    basis = lagrange_basis(t, num_basis)
    return table.t() @ (basis[:, None, None] * eye).reshape(F, Fb)


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
        return level_cols_weights(x, self.resolutions, self.table_size)

    def plane(self, axes=None, slot0: int = 0) -> Plane:
        """The encoding's lookup of the points' columns ``axes`` (all D by
        default) into its L*T slots from ``slot0``."""
        return Plane(tuple(range(self.dim)) if axes is None else tuple(axes),
                     slot0, self.log2_hashmap_size)

    def apply(self, table: torch.Tensor, x: torch.Tensor,
              precision: str = "f32") -> torch.Tensor:
        """table [L*T, F'] (a view: ``param.t()`` of a stored table),
        x [N, D] -> [N, L*F'] level-major."""
        return hash_lookup([table], [Query(x, 0, (self.plane(),))],
                           self.resolutions, precision)[0]


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

    def blended_table(self, tables: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
        """[TR, F, L*T] -> the time-bin lerp [F, L*T] at scalar t."""
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
        return (1.0 - w2) * t1 + w2 * t2


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
        return self.static_grid.apply(self.static.t(), x, precision)

    def _planes(self):
        """The three planes' lookups into their folded tables laid side
        by side."""
        planes, slot0 = [], 0
        for g, axes in zip(self.dynamic_grids, self.PLANE_AXES):
            planes.append(g.grid.plane(axes, slot0))
            slot0 += g.grid.n_cols
        return tuple(planes)

    def _dynamic_folded(self, t):
        """The three planes' tables at scalar t, lerped side by side and
        folded once: row-major [S, F/B]."""
        blended = torch.cat([g.blended_table(getattr(self, k), t)
                             for g, k in zip(self.dynamic_grids,
                                             self.PLANE_KEYS)], dim=1)
        return lagrange_fold_table(blended, t,
                                   self.dynamic_grids[0].num_basis)

    def apply_dynamic(self, x, t, precision="f32"):
        """x: [N, 3] in [0,1]; scalar t -> [N, n_output_dims_dynamic]."""
        return hash_lookup([self._dynamic_folded(t)],
                           [Query(x, 0, self._planes())],
                           self.static_grid.resolutions, precision)[0]

    def apply_dynamic_fused3(self, x, x1, x2, t, t1, t2, precision="f32"):
        """The t-query and both temporal-warp queries. Only the t-query
        carries gradient; the warp queries' positions, folded tables and
        values are detached (the reference's no_grad re-queries)."""
        return HashGrid4D.apply_dynamic_fused3_joint(
            [self], [(x, x1, x2)], t, t1, t2, precision)[0]

    # ------------------------------------------------------------------
    # several branches (LiDAR, camera) in one call per encoder family
    # ------------------------------------------------------------------
    @staticmethod
    def apply_static_joint(grids, xs, precision="f32"):
        """``apply_static`` of each grid in ``grids`` at its points in
        ``xs``, in one lookup call (one forward launch on the card), each
        branch's table taking its gradient from its own points. Returns
        one [N_i, L*F] array per branch
        (``nvsf_tpu/models/hash_grid.py:321-348``)."""
        enc = grids[0].static_grid
        return hash_lookup([g.static.t() for g in grids],
                           [Query(x, bi, (enc.plane(),))
                            for bi, x in enumerate(xs)],
                           enc.resolutions, precision)

    @staticmethod
    def apply_dynamic_fused3_joint(grids, xs_list, t, t1, t2,
                                   precision="f32"):
        """``apply_dynamic_fused3`` of several branches
        (``nvsf_tpu/models/hash_grid.py:429-481``). ``xs_list`` holds each
        branch's (x, x1, x2). The branches' t-queries are one lookup call
        that carries gradient into each branch's folded table; the warp
        queries are a second one under no_grad. Returns one (feat_t,
        feat_t1, feat_t2) per branch."""
        res = grids[0].static_grid.resolutions
        feats = hash_lookup(
            [g._dynamic_folded(t) for g in grids],
            [Query(x, bi, g._planes())
             for bi, (g, (x, _, _)) in enumerate(zip(grids, xs_list))],
            res, precision)
        with torch.no_grad():
            tables, queries = [], []
            for g, (_, x1, x2) in zip(grids, xs_list):
                for xw, tw in ((x1, t1), (x2, t2)):
                    queries.append(Query(xw.detach(), len(tables),
                                         g._planes()))
                    tables.append(g._dynamic_folded(tw))
            warps = hash_lookup(tables, queries, res, precision)
        return [(feats[bi], warps[2 * bi], warps[2 * bi + 1])
                for bi in range(len(grids))]
