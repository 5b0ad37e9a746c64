"""Weighted multi-corner sampling of small per-segment tables (K-planes).

Counterpart of ``nvsf_tpu/ops/multihot.py::multihot_sample``:

  out[q, s, f, n] = sum_c ws[q, s, c, n] * tables[f, (q*S + s)*W + cols[q, s, c, n]]

Gradients flow to ``tables`` and, with ``need_dw``, to ``ws`` (the lerp
weights, through which the flow field learns via the warped planes); with
``need_dw=False`` the weight gradient is zero. On CUDA tensors the forward
and backward launch the kernels of ``nvsf_torch/csrc/multihot.cu`` (the
forward stages each segment's table row-major in shared memory and reads a
corner's F features as one row), so a segment's F * W floats must fit in a
block's 227 KB of shared memory; on CPU tensors they run the plain PyTorch
versions below.
"""

from __future__ import annotations

import torch

from nvsf_torch.ops import kernels


def _global_cols(cols: torch.Tensor, W: int) -> torch.Tensor:
    Q, S = cols.shape[:2]
    seg = (torch.arange(Q * S, device=cols.device, dtype=torch.int64)
           * W).reshape(Q, S, 1, 1)
    return (cols.long() + seg).reshape(-1)


def multihot_fwd_plain(tables, cols, ws, W: int) -> torch.Tensor:
    """Gather-and-weight (``nvsf_tpu/ops/multihot.py:84-93``)."""
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    v = tables.index_select(1, _global_cols(cols, W)).reshape(F, Q, S, C, Np)
    out = (ws[None] * v).sum(dim=3)                      # [F, Q, S, Np]
    return out.movedim(0, 2).contiguous()                # [Q, S, F, Np]


def multihot_bwd_plain(tables, cols, ws, g, W: int, need_dw: bool):
    """(d_tables [F, Q*S*W], d_ws [Q, S, C, Np] or None)."""
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    gc = _global_cols(cols, W)
    gf = g.movedim(2, 0)[:, :, :, None, :]               # [F, Q, S, 1, Np]
    upd = (gf * ws[None]).reshape(F, -1)                 # [F, Q*S*C*Np]
    d_tables = torch.zeros_like(tables).index_add_(1, gc, upd)
    d_ws = None
    if need_dw:
        v = tables.index_select(1, gc).reshape(F, Q, S, C, Np)
        d_ws = (v * gf).sum(dim=0)
    return d_tables, d_ws


def _check_inputs(tables, cols, ws, W):
    kernels.require_cuda("tables", tables, torch.float32, 2)
    kernels.require_cuda("cols", cols, torch.int32, 4)
    kernels.require_cuda("ws", ws, torch.float32, 4)
    Q, S, C, Np = cols.shape
    if ws.shape != cols.shape:
        raise ValueError(f"ws {tuple(ws.shape)} != cols {tuple(cols.shape)}")
    if tables.shape[1] != Q * S * W:
        raise ValueError(f"tables width {tables.shape[1]} != Q*S*W "
                         f"= {Q * S * W}")
    if C > 8 or tables.shape[0] > 16:
        raise ValueError(f"kernel takes C <= 8 corners and F <= 16 "
                         f"features, got C={C}, F={tables.shape[0]}")
    smem = tables.shape[0] * W * 4
    if smem > 232448:
        raise ValueError(f"segment F*W*4 = {smem} B exceeds the 227 KB of "
                         "shared memory a block can use")


def multihot_fwd_cuda(tables, cols, ws, W: int) -> torch.Tensor:
    _check_inputs(tables, cols, ws, W)
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    out = torch.empty((Q, S, F, Np), dtype=torch.float32,
                      device=tables.device)
    lib = kernels.library()
    rc = lib.nvsf_multihot_fwd(tables.data_ptr(), tables.shape[1],
                               cols.data_ptr(), ws.data_ptr(), out.data_ptr(),
                               Q * S, C, F, W, Np, kernels.stream_of(tables))
    kernels.check(lib, rc, "nvsf_multihot_fwd")
    kernels.LAUNCHES["multihot_fwd"] += 1
    return out


def multihot_bwd_cuda(tables, cols, ws, g, W: int, need_dw: bool):
    _check_inputs(tables, cols, ws, W)
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    kernels.require_cuda("g", g, torch.float32, 4)
    if tuple(g.shape) != (Q, S, F, Np):
        raise ValueError(f"g {tuple(g.shape)} != {(Q, S, F, Np)}")
    d_tables = torch.zeros_like(tables)
    d_ws = torch.empty_like(ws) if need_dw else None
    lib = kernels.library()
    rc = lib.nvsf_multihot_bwd(tables.data_ptr(), tables.shape[1],
                               cols.data_ptr(), ws.data_ptr(), g.data_ptr(),
                               d_tables.data_ptr(),
                               d_ws.data_ptr() if need_dw else None,
                               Q * S, C, F, W, Np, kernels.stream_of(tables))
    kernels.check(lib, rc, "nvsf_multihot_bwd")
    kernels.LAUNCHES["multihot_bwd"] += 1
    return d_tables, d_ws


class _MultihotSample(torch.autograd.Function):

    @staticmethod
    def forward(ctx, tables, cols, ws, W, need_dw):
        ctx.save_for_backward(tables, cols, ws)
        ctx.W = W
        ctx.need_dw = need_dw
        if tables.is_cuda:
            return multihot_fwd_cuda(tables, cols, ws, W)
        return multihot_fwd_plain(tables, cols, ws, W)

    @staticmethod
    def backward(ctx, g):
        tables, cols, ws = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        bwd = multihot_bwd_cuda if tables.is_cuda else multihot_bwd_plain
        d_tables, d_ws = bwd(tables, cols, ws, g, ctx.W, ctx.need_dw)
        if d_ws is None:
            d_ws = torch.zeros_like(ws)
        return d_tables, None, d_ws, None, None


def multihot_sample(tables: torch.Tensor, cols: torch.Tensor,
                    ws: torch.Tensor, seg_width: int,
                    need_dw: bool = True) -> torch.Tensor:
    """tables: [F, Q*S*seg_width]; cols: [Q, S, C, Np] int32 local columns
    in [0, seg_width); ws: matching f32 weights -> [Q, S, F, Np]."""
    return _MultihotSample.apply(tables, cols.contiguous(), ws.contiguous(),
                                 seg_width, need_dw)
