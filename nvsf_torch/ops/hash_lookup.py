"""Hash-grid lookups: the multiresolution interpolation of a table at
points, and the table's gradient.

``hash_lookup(tables, queries, resolutions)`` returns for each query an
[N, P*L*F] array: for each of its P planes (D of the points' columns, L
levels of T slots of its table from slot ``slot0``), level-major, the F
features of the point's 2^D grid corners weighted by their multilinear
weights and summed. Levels whose dense grid fits in T slots are indexed
densely, finer ones through the instant-ngp spatial hash with the
reference's uint32 wraparound (``level_cols_weights``).

Tables are [S, F] views, each slot's F features along the second axis:
a row-major tensor (the folds write the folded tables so,
``models/hash_grid.py``) or ``param.t()`` of a features-major [F, S]
parameter. A table's gradient has its view's layout underneath: the
rows, or the [F, S] transpose.

On a CUDA device every lookup runs the hand-written kernels: the forward
``csrc/hash_encode.cu`` (one launch per ``MAX_LOOKUPS`` planes of the
call's queries, reading a row-major copy of a features-major table made
in the call) and the gradient B1's rows stage in ``csrc/segsum.cu`` (one
launch per table), which recomputes every update from the saved points
and hands a features-major table its gradient through B1's transpose. No
corner, index, weight or gathered value reaches memory, and the backward
saves only the points. The kernels take D in ``KERNEL_DIMS``, up to
``MAX_FEATURES`` features and ``MAX_LEVELS`` levels; a lookup on the card
outside them raises. On the CPU a call is the plain composition
``lookup_plain``: ``level_cols_weights``, one ``table_gather`` a query
(whose backward is ``segment_add_fm``) and the corner sum. The gradient
rounds each update to bf16 before the f32 sum with ``precision="bf16"``,
as ``segment_add_fm`` does. The points get no gradient.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from nvsf_torch.lib.constants import device_constant
from nvsf_torch.ops import kernels
from nvsf_torch.ops.gather import table_gather
from nvsf_torch.ops.segsum import PRECISIONS

KERNEL_DIMS = (2, 3)
MAX_FEATURES = 32
MAX_LEVELS = 16
MAX_LOOKUPS = 12      # planes a launch takes by value (csrc/hash_grid.cuh)

_PRIMES = (1, 2654435761, 805459861, 3674653429)
_LOW32 = 0xFFFFFFFF


class Plane(NamedTuple):
    """One view of a query's points into its table."""
    axes: Tuple[int, ...]    # the D columns of the points it reads
    slot0: int               # its first slot in the table
    log2_T: int              # slots a level: 2^log2_T


class Query(NamedTuple):
    x: torch.Tensor          # [N, >= D] points in [0, 1]
    table: int               # index into the call's tables
    planes: Tuple[Plane, ...]


def kernel_refusal(dim: int, F: int, n_levels: int):
    """Why the kernels cannot take a lookup of D = ``dim``, F features and
    ``n_levels`` levels, or None where they can."""
    if dim not in KERNEL_DIMS:
        return f"D = {dim} is not in {KERNEL_DIMS}"
    if not 1 <= F <= MAX_FEATURES:
        return f"F = {F} is not in [1, {MAX_FEATURES}]"
    if not 1 <= n_levels <= MAX_LEVELS:
        return f"{n_levels} levels is not in [1, {MAX_LEVELS}]"
    return None


def dense_levels(resolutions, dim: int, T: int):
    return tuple((r + 1) ** dim <= T for r in resolutions)


# ----------------------------------------------------------------------
# the plain version: the reference's composition
# ----------------------------------------------------------------------

def level_cols_weights(x: torch.Tensor, resolutions: Sequence[int], T: int):
    """x: [N, D] in [0, 1] -> (cols [L*C*N] int32 columns into L levels of
    T slots, wc [L, C, N] multilinear corner weights)."""
    N, D = x.shape
    L = len(resolutions)
    dev = x.device
    offs = np.stack(np.meshgrid(*([np.arange(2)] * D), indexing="ij"),
                    axis=-1).reshape(-1, D)
    offs = device_constant(tuple(map(tuple, offs.tolist())), torch.int64,
                           dev)                          # [C, D]
    res = device_constant(tuple(resolutions), torch.int64, dev)
    dense = device_constant(dense_levels(resolutions, D, T), torch.bool, dev)
    level_offs = torch.arange(L, dtype=torch.int64, device=dev) * T

    pos = x.to(torch.float32)[:, None, :] \
        * res.to(torch.float32)[None, :, None]            # [N, L, D]
    c0f = torch.floor(pos)
    w = pos - c0f
    corners = c0f.long()[:, :, None, :] + offs[None, None]  # [N, L, C, D]
    corners = torch.minimum(corners.clamp_min(0), res[None, :, None, None])
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


def reduce_corners(vals: torch.Tensor, wc: torch.Tensor) -> torch.Tensor:
    """vals [F, L*C*N] gathered corners, wc [L, C, N] -> [N, L*F]."""
    L, C, N = wc.shape
    v = vals.reshape(-1, L, C, N)
    feat = (v * wc[None]).sum(dim=2)                      # [F, L, N]
    return feat.permute(2, 1, 0).reshape(N, -1)


def _plane_x(x: torch.Tensor, axes) -> torch.Tensor:
    """The plane's columns of the points (stacked: an index list would be
    a copy from the host, a sync)."""
    if tuple(axes) == tuple(range(x.shape[1])):
        return x
    return torch.stack([x[:, a] for a in axes], dim=-1)


def lookup_plain(tables, queries: Sequence[Query], resolutions,
                 precision: str = "f32") -> List[torch.Tensor]:
    """The plain version: per query, the planes' columns and weights, one
    gather from its table (read features-major: ``table.t()``), the
    corner sums."""
    outs = []
    for q in queries:
        cols, wcs = [], []
        for pl in q.planes:
            c, wc = level_cols_weights(_plane_x(q.x, pl.axes), resolutions,
                                       1 << pl.log2_T)
            cols.append(c + pl.slot0 if pl.slot0 else c)
            wcs.append(wc)
        vals = table_gather(tables[q.table].t(),
                            cols[0] if len(cols) == 1 else torch.cat(cols),
                            precision=precision)
        feats, p = [], 0
        for wc in wcs:
            n = wc.numel()
            feats.append(reduce_corners(vals[:, p:p + n], wc))
            p += n
        outs.append(feats[0] if len(feats) == 1 else torch.cat(feats, -1))
    return outs


# ----------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------

def _lookup_words(x, pl, resolutions, table_ptr, slot_ld, feat_ld, out_ptr,
                  out_ld):
    """One nvsf::HashLookup as int64 words."""
    D = len(pl.axes)
    offs = [a * x.stride(1) for a in pl.axes] + [0] * (3 - D)
    dense = sum(1 << l for l, d in enumerate(
        dense_levels(resolutions, D, 1 << pl.log2_T)) if d)
    return [x.data_ptr(), x.stride(0), *offs, table_ptr, slot_ld, feat_ld,
            pl.log2_T, dense, x.shape[0], out_ptr, out_ld]


def _check_points(queries, dev):
    for q in queries:
        if q.x.device != dev or q.x.dtype != torch.float32 \
                or q.x.dim() != 2:
            raise ValueError(f"points must be 2-D float32 on {dev}, got "
                             f"{q.x.dtype} {tuple(q.x.shape)} on "
                             f"{q.x.device}")
        if q.x.shape[1] <= max(max(pl.axes) for pl in q.planes):
            raise ValueError(f"points [{q.x.shape[1]} columns] lack the "
                             f"axes {[pl.axes for pl in q.planes]}")


def _launch(name, words, resolutions, D, F, tail):
    """Launches ``name`` on the lookups ``words``, MAX_LOOKUPS at a time;
    ``tail(last)`` gives the arguments after F of each launch."""
    lib = kernels.library()
    fn = getattr(lib, name)
    res = np.asarray(resolutions, dtype=np.int32)
    for k in range(0, len(words), MAX_LOOKUPS):
        chunk = np.asarray(words[k:k + MAX_LOOKUPS], dtype=np.int64)
        rc = fn(chunk.ctypes.data, chunk.shape[0], res.ctypes.data,
                len(resolutions), D, F, *tail(k + MAX_LOOKUPS >= len(words)))
        kernels.check(lib, rc, name)


def lookup_fwd_cuda(reads, queries: Sequence[Query], resolutions):
    """The forward kernel. ``reads``: each table as an [S, F] view, any
    strides (row-major [S, F] tensors, or ``table.t()`` of a
    features-major one)."""
    F = reads[0].shape[1]
    D = len(queries[0].planes[0].axes)
    L = len(resolutions)
    dev = reads[0].device
    _check_points(queries, dev)
    outs, words = [], []
    for q in queries:
        out = torch.empty((q.x.shape[0], len(q.planes) * L * F),
                          dtype=torch.float32, device=dev)
        outs.append(out)
        tab = reads[q.table]
        align = 16 if F % 4 == 0 else 8 if F == 2 else 4
        if tab.stride(1) == 1 and tab.stride(0) == F \
                and tab.data_ptr() % align:
            raise ValueError(f"a row-major table must be aligned to {align} "
                             "bytes")
        for p, pl in enumerate(q.planes):
            words.append(_lookup_words(
                q.x, pl, resolutions,
                tab.data_ptr() + 4 * pl.slot0 * tab.stride(0),
                tab.stride(0), tab.stride(1),
                out.data_ptr() + 4 * p * L * F, out.stride(0)))
    stream = kernels.stream_of(reads[0])
    n0 = len(words)
    _launch("nvsf_hash_encode_fwd", words, resolutions, D, F,
            lambda last: (stream,))
    kernels.LAUNCHES["hash_encode_fwd"] += -(-n0 // MAX_LOOKUPS)
    return outs


def lookup_bwd_cuda(queries: Sequence[Query], grads, resolutions, S: int,
                    F: int, precision: str, features_major: bool,
                    device) -> torch.Tensor:
    """The gradient kernel: the [S, F] gradient of one table from the
    queries that read it and their outputs' gradients ``grads``; rows
    underneath, or with ``features_major`` the ``.t()`` of an [F, S]
    tensor, written by B1's transpose."""
    fm = features_major and F > 1    # at F = 1 the two layouts are one
    if not queries:    # no output of this table's queries took gradient
        z = torch.zeros((F, S) if fm else (S, F), dtype=torch.float32,
                        device=device)
        return z.t() if fm else z
    D = len(queries[0].planes[0].axes)
    L = len(resolutions)
    scratch = torch.zeros((S, F), dtype=torch.float32, device=device)
    out = torch.empty((F, S), dtype=torch.float32, device=device) if fm \
        else scratch
    words = []
    for q, g in zip(queries, grads):
        g = g.to(torch.float32)
        if g.stride(1) != 1:
            g = g.contiguous()
        for p, pl in enumerate(q.planes):
            words.append(_lookup_words(
                q.x, pl, resolutions, scratch.data_ptr() + 4 * pl.slot0 * F,
                F, 1, g.data_ptr() + 4 * p * L * F, g.stride(0)))
    stream = kernels.stream_of(scratch)
    bf16 = int(precision == "bf16")
    # every launch adds into the scratch; the last one transposes it
    _launch("nvsf_hash_encode_bwd", words, resolutions, D, F,
            lambda last: (scratch.data_ptr(),
                          out.data_ptr() if last else scratch.data_ptr(),
                          S, bf16, stream))
    kernels.LAUNCHES["hash_encode_bwd"] += max(-(-len(words) // MAX_LOOKUPS),
                                               1)
    return out.t() if fm else out


def _features_major(table: torch.Tensor) -> bool:
    """Whether an [S, F] view lies features-major underneath."""
    return table.shape[1] > 1 and table.stride(1) != 1


def _reads(tables):
    """Each table as the row-major [S, F] tensor the forward reads."""
    return [t.detach().contiguous() for t in tables]


class _HashLookup(torch.autograd.Function):

    @staticmethod
    def forward(ctx, call, *args):
        resolutions, precision, layout = call
        n_tables = len(args) - len(layout)
        tables, xs = args[:n_tables], args[n_tables:]
        queries = [Query(x, ti, planes) for x, (ti, planes)
                   in zip(xs, layout)]
        ctx.call = call
        ctx.tables = [(*t.shape, _features_major(t)) for t in tables]
        ctx.save_for_backward(*xs)
        return tuple(lookup_fwd_cuda(_reads(tables), queries, resolutions))

    @staticmethod
    def backward(ctx, *gs):
        resolutions, precision, layout = ctx.call
        xs = ctx.saved_tensors
        grads = []
        for ti, (S, F, fm) in enumerate(ctx.tables):
            if not ctx.needs_input_grad[1 + ti]:
                grads.append(None)
                continue
            sel = [(Query(x, t, planes), g) for x, g, (t, planes)
                   in zip(xs, gs, layout) if t == ti and g is not None]
            grads.append(lookup_bwd_cuda(
                [q for q, _ in sel], [g for _, g in sel], resolutions, S, F,
                precision, fm, xs[0].device))
        return (None, *grads, *([None] * len(xs)))


def hash_lookup(tables: Sequence[torch.Tensor], queries: Sequence[Query],
                resolutions: Sequence[int],
                precision: str = "f32") -> List[torch.Tensor]:
    """Each query's [N, P*L*F] features from its [S, F] table (module
    docstring)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    dev = tables[0].device
    if dev.type != "cuda":
        return lookup_plain(tables, queries, resolutions, precision)
    refusal = kernel_refusal(len(queries[0].planes[0].axes),
                             tables[0].shape[1], len(resolutions))
    if refusal is not None:
        raise ValueError(f"the hash-grid kernels take no such lookup: "
                         f"{refusal}")
    grad = torch.is_grad_enabled()
    if grad and any(q.x.requires_grad for q in queries):
        raise ValueError("the hash-grid kernels compute no gradient for the "
                         "points; pass them detached")
    if grad and any(t.requires_grad for t in tables):
        call = (tuple(resolutions), precision,
                tuple((q.table, q.planes) for q in queries))
        return list(_HashLookup.apply(call, *tables,
                                      *(q.x for q in queries)))
    return lookup_fwd_cuda(_reads(tables), queries, resolutions)
