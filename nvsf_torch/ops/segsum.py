"""Segment-add into a features-major table: the backward of a table gather.

``segment_add_fm(cols, vals, T)`` is ``zeros(F, T).index_add_(1, cols, vals)``.
On a CUDA tensor it launches the hand-written kernels of
``nvsf_torch/csrc/segsum.cu`` (one thread per update, warp-aggregated vector
atomics into a row-major [T, F] scratch, then a transpose to [F, T]; at
F = 1 straight into the table); on a CPU tensor it runs the plain PyTorch
version below. Counterpart of ``nvsf_tpu/ops/segsum.py::segment_add_fm``.
The hash-grid lookups' gradients on the card run the same kernels through
another entry, whose input stage recomputes each update from the points
instead of reading cols and vals (``ops/hash_lookup.py``); this one is
their gradient on the CPU, through ``table_gather``.

precision: ``"bf16"`` rounds every update to bf16 before the f32 sum, as the
TPU kernel's packed payload does; ``"f32"`` sums the values as given.

Which one a training step uses is the port's own rule: the field rounds its
table gradients to bf16 when the step computes in bf16 (``fp16`` on, see
``NVSFField.table_grad_precision``) and sums them exactly otherwise, on
either device. The reference ties the rounding to the device instead: its
TPU kernel always rounds and its scatter-add off the TPU never does. The port
departs from it so that an f32 step on the card stays exact and the card and
the CPU compute the same function of one configuration.
"""

from __future__ import annotations

import torch

from nvsf_torch.ops import kernels

PRECISIONS = ("bf16", "f32")
MAX_F = 32    # features per slot the kernel takes (its transpose tile)


def segment_add_plain(cols: torch.Tensor, vals: torch.Tensor, T: int,
                      precision: str = "bf16") -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of the (rounded) values."""
    if precision == "bf16":
        vals = vals.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((vals.shape[0], T), dtype=torch.float32,
                      device=vals.device)
    return out.index_add_(1, cols.long(), vals.to(torch.float32))


def segment_add_cuda(cols: torch.Tensor, vals: torch.Tensor, T: int,
                     precision: str = "bf16") -> torch.Tensor:
    """The CUDA kernel. ``vals`` may be a column slice of a wider [F, *]
    tensor (unit column stride); it is read in place."""
    kernels.require_cuda("cols", cols, torch.int32, 1)
    if not vals.is_cuda or vals.dtype != torch.float32 or vals.dim() != 2:
        raise ValueError("vals must be a 2-D float32 CUDA tensor, got "
                         f"{vals.dtype} {tuple(vals.shape)} on {vals.device}")
    F, M = vals.shape
    if cols.shape[0] != M:
        raise ValueError(f"cols has {cols.shape[0]} entries, vals {M}")
    if F > MAX_F:
        raise ValueError(f"kernel takes F <= {MAX_F} features, got {F}")
    if M > 1 and vals.stride(1) != 1:
        vals = vals.contiguous()
    if F == 1:   # [T, 1] rows are the [1, T] table: summed in place
        out = rows = torch.zeros((1, T), dtype=torch.float32,
                                 device=vals.device)
    else:
        rows = torch.zeros((T, F), dtype=torch.float32, device=vals.device)
        out = torch.empty((F, T), dtype=torch.float32, device=vals.device)
    lib = kernels.library()
    rc = lib.nvsf_segment_add(cols.data_ptr(), vals.data_ptr(),
                              vals.stride(0), rows.data_ptr(), out.data_ptr(),
                              T, M, F, int(precision == "bf16"),
                              kernels.stream_of(vals))
    kernels.check(lib, rc, "nvsf_segment_add")
    kernels.LAUNCHES["segment_add"] += 1
    if precision == "f32":
        kernels.LAUNCHES["segment_add_f32"] += 1
    return out


def segment_add_fm(cols: torch.Tensor, vals: torch.Tensor, T: int,
                   precision: str = "bf16") -> torch.Tensor:
    """cols: [M] int32 in [0, T); vals: [F, M] f32 -> [F, T] with
    ``out[:, t] = sum(vals[:, cols == t])``."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    if vals.is_cuda:
        return segment_add_cuda(cols, vals, T, precision)
    return segment_add_plain(cols, vals, T, precision)
