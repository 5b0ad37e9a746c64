"""Occupancy grid and static-shape sample compaction (counterpart of
``nvsf_tpu/ops/occupancy.py``).

A dense density grid [G, G, G] is refreshed from the field (max over a few
query times, decayed); per ray, T candidate depths are tested against it and
compacted to K samples spread evenly over the occupied candidates, with a
validity mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch


@dataclass(frozen=True)
class OccupancyGrid:
    grid_size: int = 128
    bound: float = 1.0
    decay: float = 0.8
    update_fraction: int = 4
    init_density: float = 32.0

    @property
    def n_cells(self) -> int:
        return self.grid_size ** 3

    def init(self, device=None) -> torch.Tensor:
        """Fully occupied at the start; empty space decays away."""
        return torch.full((self.grid_size,) * 3, self.init_density,
                          dtype=torch.float32, device=device)

    def cell_centers(self, cells: torch.Tensor) -> torch.Tensor:
        """[M] flat cell ids -> [M, 3] world coords of the cell centers."""
        G = self.grid_size
        z = cells % G
        y = (cells // G) % G
        x = cells // (G * G)
        u = (torch.stack([x, y, z], dim=-1).to(torch.float32) + 0.5) / G
        return (u * 2.0 - 1.0) * self.bound

    @torch.no_grad()
    def update(self, grid: torch.Tensor,
               density_fn: Callable[[torch.Tensor, torch.Tensor],
                                    torch.Tensor],
               times: torch.Tensor, generator=None,
               cells: Optional[torch.Tensor] = None,
               jitter_u: Optional[torch.Tensor] = None,
               query_chunk: int = 1 << 18) -> torch.Tensor:
        """Refresh G^3 / update_fraction random cells: new = max(old *
        decay, max over ``times`` of the field's sigma at a jittered point
        of the cell). ``cells`` [M] and ``jitter_u`` [M, 3] (uniform in
        [0, 1)) replace the draws from ``generator`` when given. The field
        is queried ``query_chunk`` points at a time: the chunks bound its
        temporaries, and each costs the host the dispatch of one eager
        forward, so they are 8x the reference's 32,768."""
        G = self.grid_size
        M = self.n_cells // self.update_fraction
        dev = grid.device
        if cells is None:
            cells = torch.randint(0, self.n_cells, (M,), generator=generator,
                                  device=dev)
        if jitter_u is None:
            jitter_u = torch.rand((M, 3), generator=generator, device=dev)
        cells = cells.to(dev).long()
        pts = self.cell_centers(cells) \
            + (jitter_u.to(dev) - 0.5) * (2.0 * self.bound / G)
        sigma = None
        for t in torch.as_tensor(times, dtype=torch.float32,
                                 device=dev).reshape(-1):
            s = torch.cat([density_fn(pts[i:i + query_chunk], t)
                           for i in range(0, M, query_chunk)])
            sigma = s if sigma is None else torch.maximum(sigma, s)
        flat = grid.reshape(-1).clone()
        new = torch.maximum(flat[cells] * self.decay, sigma)
        # a cell drawn twice takes the larger of its writes: one of them,
        # as the reference leaves it, but the same one on every run (a
        # plain scatter lands them in any order on the card)
        flat.scatter_reduce_(0, cells, new, "amax", include_self=False)
        return flat.reshape(grid.shape)

    def occupied_at(self, grid, xyz, thresh):
        """xyz: [..., 3] world coords -> bool occupancy."""
        G = self.grid_size
        u = (xyz / self.bound + 1.0) * 0.5
        ijk = torch.clamp((u * G).to(torch.int64), 0, G - 1)
        flat_idx = (ijk[..., 0] * G + ijk[..., 1]) * G + ijk[..., 2]
        return grid.reshape(-1)[flat_idx] > thresh

    def compact_samples(self, grid, rays_o, rays_d, z_candidates, K: int,
                        thresh: float):
        """z_candidates [N, T] ascending -> (z_sel [N, K] ascending,
        valid [N, K]): all occupied candidates when there are at most K,
        else K evenly strided ones."""
        N, T = z_candidates.shape
        xyz = rays_o[:, None, :] + rays_d[:, None, :] \
            * z_candidates[..., None]
        occ = self.occupied_at(grid, xyz, thresh)             # [N, T]
        m = occ.sum(dim=-1, keepdim=True, dtype=torch.int32)  # [N, 1]
        # occupied candidates first, z order kept (stable sort of ~occ)
        order = torch.argsort((~occ).to(torch.int32), dim=-1, stable=True)
        z_packed = torch.gather(z_candidates, 1, order)
        k = torch.arange(K, device=z_candidates.device)[None, :]
        strided = ((k.to(torch.float32) + 0.5) * m / K).to(torch.int64)
        ranks = torch.where(m > K, strided,
                            torch.minimum(k, torch.clamp(m - 1, min=0)))
        z_sel = torch.gather(z_packed, 1, ranks)
        valid = k < torch.clamp(m, max=K)
        z_sel = torch.where(valid, z_sel, z_candidates[:, -1:])
        return z_sel, valid
