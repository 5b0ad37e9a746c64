"""Table gather whose backward is the segment-add kernel.

``table_gather(table, cols)`` is ``table[:, cols]`` for a features-major
table [F, T]; its gradient goes through ``segment_add_fm``. Counterpart of
``nvsf_tpu/ops/gather.py::table_gather``: the saved residual is the int32
column vector alone (the gathered values are never kept for backward), and
``n_grad`` restricts the gradient to the first ``n_grad`` rows, whose
columns lie in [0, grad_cols_T) — the fused three-query dynamic-hash gather,
whose two warp queries carry no gradient.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as Fn

from nvsf_torch.ops.segsum import segment_add_fm


class _TableGather(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, cols, n_grad, grad_cols_T, precision):
        ctx.save_for_backward(cols)
        ctx.T = table.shape[1]
        ctx.n_grad = n_grad
        ctx.grad_cols_T = grad_cols_T
        ctx.precision = precision
        return table.index_select(1, cols)

    @staticmethod
    def backward(ctx, g):
        (cols,) = ctx.saved_tensors
        g = g.to(torch.float32)
        if ctx.n_grad is None:
            d_table = segment_add_fm(cols, g, ctx.T, ctx.precision)
        else:
            d_seg = segment_add_fm(cols[:ctx.n_grad], g[:, :ctx.n_grad],
                                   ctx.grad_cols_T, ctx.precision)
            d_table = Fn.pad(d_seg, (0, ctx.T - ctx.grad_cols_T))
        return d_table, None, None, None, None


def table_gather(table: torch.Tensor, cols: torch.Tensor,
                 n_grad: Optional[int] = None,
                 grad_cols_T: Optional[int] = None,
                 precision: str = "bf16") -> torch.Tensor:
    """table: [F, T]; cols: [M] int32 -> [F, M]."""
    if n_grad is not None and grad_cols_T is None:
        grad_cols_T = table.shape[1]
    return _TableGather.apply(table, cols, n_grad, grad_cols_T, precision)
