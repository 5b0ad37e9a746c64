"""Table gather whose backward is the segment-add kernel.

``table_gather(table, cols)`` is ``table[:, cols]`` for a features-major
table [F, T]; its gradient goes through ``segment_add_fm``. Counterpart of
``nvsf_tpu/ops/gather.py::table_gather``: the saved residual is the int32
column vector alone (the gathered values are never kept for backward). The
JAX package's ``n_grad`` prefix (its fused three-query dynamic-hash gather)
has no counterpart: the port's hash lookups (``ops/hash_lookup.py``) run
their warp queries apart, under ``no_grad``.
"""

from __future__ import annotations

import torch

from nvsf_torch.ops.segsum import segment_add_fm


class _TableGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, cols, precision):
        ctx.save_for_backward(cols)
        ctx.T = table.shape[1]
        ctx.precision = precision
        return table.index_select(1, cols)

    @staticmethod
    def backward(ctx, g):
        (cols,) = ctx.saved_tensors
        d_table = segment_add_fm(cols, g.to(torch.float32), ctx.T,
                                 ctx.precision)
        return d_table, None, None


def table_gather(table: torch.Tensor, cols: torch.Tensor,
                 precision: str = "bf16") -> torch.Tensor:
    """table: [F, T]; cols: [M] int32 -> [F, M]."""
    return _TableGather.apply(table, cols, precision)
