"""Chamfer distance for the training losses (counterpart of the XLA path of
``nvsf_tpu/ops/chamfer.py``; the eval-only Pallas kernel is not ported).

The nearest neighbour is found without gradient, streaming over blocks of
the second cloud (|a|^2 + |b|^2 - 2 a.b, O(N * block) memory); the distance
to it is then recomputed with gradient. That is the min's subgradient: the
whole gradient goes to the argmin, as JAX's autodiff of the scanned min
gives it.
"""

from __future__ import annotations

from typing import Optional

import torch

_BIG = 1e10


def min_dist2(a: torch.Tensor, b: torch.Tensor,
              b_mask: Optional[torch.Tensor] = None,
              block_m: int = 4096) -> torch.Tensor:
    """For each point of ``a`` [N, 3], the squared distance to its nearest
    valid point of ``b`` [M, 3] (1e10 when ``b`` has none)."""
    N, M = a.shape[0], b.shape[0]
    with torch.no_grad():
        a2 = (a * a).sum(-1, keepdim=True)
        best = torch.full((N,), _BIG, dtype=a.dtype, device=a.device)
        arg = torch.zeros((N,), dtype=torch.int64, device=a.device)
        for j in range(0, M, block_m):
            bb = b[j:j + block_m]
            d2 = a2 + (bb * bb).sum(-1)[None, :] - 2.0 * (a @ bb.t())
            if b_mask is not None:
                d2 = torch.where(b_mask[None, j:j + block_m], d2, _BIG)
            v, i = d2.min(dim=-1)
            take = v < best
            best = torch.where(take, v, best)
            arg = torch.where(take, i + j, arg)
    bs = b[arg]
    d = (a * a).sum(-1) + (bs * bs).sum(-1) - 2.0 * (a * bs).sum(-1)
    d = torch.where(best >= _BIG, torch.full_like(d, _BIG), d)
    return torch.clamp(d, min=0.0)


def chamfer_distance(a, b, a_mask=None, b_mask=None, block_m: int = 4096):
    """(dist1 [N], dist2 [M]): squared NN distances both ways, zeroed at
    invalid points."""
    d1 = min_dist2(a, b, b_mask, block_m)
    d2 = min_dist2(b, a, a_mask, block_m)
    if a_mask is not None:
        d1 = torch.where(a_mask, d1, 0.0)
    if b_mask is not None:
        d2 = torch.where(b_mask, d2, 0.0)
    return d1, d2
