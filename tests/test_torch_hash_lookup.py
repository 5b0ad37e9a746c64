"""The hash-grid lookup entry (``nvsf_torch/ops/hash_lookup.py``) on the
CPU, where it runs the plain composition: bit for bit the composition of
``level_cols_weights``, ``table_gather`` and ``reduce_corners``, forward
and table gradient, in both precisions, from [S, F] views of either
layout; dense and hashed levels, points on the faces 0 and 1 and at the
finest resolution, where the hash's int64 products pass 2^32 and keep
their low 32 bits. The dynamic grid's t-query carries gradient and its
warp queries are lookups under ``no_grad``. The kernels themselves run on
the card only (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from nvsf_torch.models.hash_grid import (HashGrid4D, lagrange_basis,
                                         lagrange_fold_table,
                                         level_resolutions)
from nvsf_torch.ops import hash_lookup as hl
from nvsf_torch.ops import kernels
from nvsf_torch.ops.gather import table_gather

from test_torch_models import one_torch_thread  # noqa: F401

# 4 levels from 16 to 32768: level 0 (17^2 <= 2^9, 17^3 > 2^9) is dense in
# 2D, every other level hashed; the finest corners times the primes pass
# 2^32
RES = level_resolutions(16, 32768, 4)
LOG2_T = {2: (9, 8, 8), 3: (12,)}
AXES = {2: ((0, 1), (0, 2), (1, 2)), 3: ((0, 1, 2),)}


def _points(rng, n):
    x = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    x[:5] = 1.0
    x[5:8] = 0.0
    x[8:11] = np.float32(1 - 2 ** -16)    # the finest level's last cell
    return torch.from_numpy(x)


def _planes(D):
    planes, slot0 = [], 0
    for axes, lg in zip(AXES[D], LOG2_T[D]):
        planes.append(hl.Plane(axes, slot0, lg))
        slot0 += len(RES) << lg
    return tuple(planes), slot0


def _composition(table, x, planes, precision):
    """One query as the composition: its planes' columns and weights, one
    gather from the features-major [F, S] ``table``, the corner sums."""
    cols, wcs = [], []
    for pl in planes:
        xp = torch.stack([x[:, a] for a in pl.axes], dim=-1)
        c, wc = hl.level_cols_weights(xp, RES, 1 << pl.log2_T)
        cols.append(c + pl.slot0)
        wcs.append(wc)
    vals = table_gather(table, torch.cat(cols), precision=precision)
    outs, p = [], 0
    for wc in wcs:
        n = wc.numel()
        outs.append(hl.reduce_corners(vals[:, p:p + n], wc))
        p += n
    return torch.cat(outs, dim=-1)


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("D", [2, 3])
def test_lookup_matches_the_composition_bit_for_bit(D, precision):
    """D = 3: the static grid's lookup at two branches' points, each into
    its own features-major table, read as ``param.t()``. D = 2: the three
    dynamic planes into row-major (folded) tables, the t-query carrying
    gradient into its table and the two warp queries under ``no_grad``
    into theirs."""
    rng = np.random.default_rng(D)
    planes, S = _planes(D)
    F = 4 if D == 3 else 2
    shape = (F, S) if D == 3 else (S, F)
    tabs = [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(3 if D == 2 else 2)]

    def view(t):       # the lookup's [S, F] view
        return t.t() if D == 3 else t

    def fm(t):         # the gather's [F, S] view
        return t if D == 3 else t.t()

    xs = [_points(rng, 300), _points(rng, 211)]
    if D == 2:
        xs = [xs[0], xs[0] + 0.01, xs[0] - 0.02]
    cts = [torch.from_numpy(rng.standard_normal(
        (x.shape[0], len(planes) * len(RES) * F)).astype(np.float32))
        for x in xs]

    got_t = [t.clone().requires_grad_(True) for t in tabs]
    before = dict(kernels.LAUNCHES)
    if D == 3:
        got = hl.hash_lookup([view(t) for t in got_t],
                             [hl.Query(x, i, planes)
                              for i, x in enumerate(xs)], RES, precision)
    else:
        got = hl.hash_lookup([got_t[0]], [hl.Query(xs[0], 0, planes)], RES,
                             precision)
        with torch.no_grad():
            got += hl.hash_lookup(got_t[1:], [
                hl.Query(x, i, planes) for i, x in enumerate(xs[1:])],
                RES, precision)
    sum((o * c).sum() for o, c in zip(got, cts)).backward()
    assert kernels.LAUNCHES == before     # the CPU launches and counts none

    ref_t = [t.clone().requires_grad_(True) for t in tabs]
    ref = []
    for i, (t, x) in enumerate(zip(ref_t, xs)):
        if D == 2 and i > 0:
            with torch.no_grad():
                ref.append(_composition(fm(t), x, planes, precision))
        else:
            ref.append(_composition(fm(t), x, planes, precision))
    sum((o * c).sum() for o, c in zip(ref, cts)).backward()
    for o, r in zip(got, ref):
        assert torch.equal(o.detach(), r.detach())
    n_grad = 2 if D == 3 else 1
    for g, r in zip(got_t[:n_grad], ref_t):
        assert g.grad.shape == shape and torch.equal(g.grad, r.grad)
    assert all(t.grad is None for t in got_t[n_grad:])
    assert got_t[0].grad.abs().sum() > 0


def test_warp_queries_are_no_grad_lookups():
    """``apply_dynamic_fused3``: the t-query is ``apply_dynamic`` at t and
    takes every table gradient; each warp query is ``apply_dynamic`` at its
    own points and time under ``no_grad``, bit for bit."""
    grid = HashGrid4D(base_resolution=16, max_resolution=4096,
                      time_resolution=4, n_levels=4, n_features_per_level=8,
                      log2_hashmap_size=12, hash_size_dynamic=(10, 9, 9),
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in grid.parameters():
            p.mul_(1e4)
    rng = np.random.default_rng(5)
    x = _points(rng, 200)
    x1, x2 = (x * 0.9 + 0.05).requires_grad_(True), x * 0.8 + 0.1
    t, t1, t2 = (torch.tensor(v) for v in (0.4, 0.3, 0.5))
    ft, f1, f2 = grid.apply_dynamic_fused3(x, x1, x2, t, t1, t2, "f32")
    assert not f1.requires_grad and not f2.requires_grad
    ct = torch.from_numpy(rng.standard_normal(ft.shape).astype(np.float32))
    (ft * ct).sum().backward()
    got = {k: getattr(grid, k).grad.clone() for k in grid.PLANE_KEYS}
    grid.zero_grad()
    ref = grid.apply_dynamic(x, t, "f32")
    (ref * ct).sum().backward()
    assert torch.equal(ft.detach(), ref.detach())
    for k in grid.PLANE_KEYS:
        assert torch.equal(got[k], getattr(grid, k).grad)
        assert got[k].abs().sum() > 0
    assert grid.static.grad is None
    with torch.no_grad():
        for f, xw, tw in ((f1, x1, t1), (f2, x2, t2)):
            assert torch.equal(f, grid.apply_dynamic(xw, tw, "f32"))


def test_hashed_columns_keep_the_low_32_bits():
    """At the finest level the hashed column is the uint32 hash of the
    clamped corner, & (T - 1): computed here from Python integers."""
    x = torch.tensor([[1.0, 1.0, 1.0], [0.7, 0.3, 0.9999]])
    T = 1 << 12
    cols, _ = hl.level_cols_weights(x, RES, T)
    L, C, N = len(RES), 8, 2
    cols = cols.reshape(L, C, N)
    r = RES[-1]
    primes = (1, 2654435761, 805459861)
    for n in range(N):
        base = [int(np.floor(np.float32(v) * np.float32(r)))
                for v in x[n].tolist()]
        for c in range(C):
            corner = [min(max(b + ((c >> (2 - d)) & 1), 0), r)
                      for d, b in enumerate(base)]
            h = 0
            for d in range(3):
                h ^= (corner[d] * primes[d]) & 0xFFFFFFFF
            assert int(cols[L - 1, c, n]) == (L - 1) * T + (h & (T - 1))
    assert max(c * primes[1] for c in corner) > 2 ** 32


@pytest.mark.parametrize("num_basis,F", [(4, 32), (4, 8), (4, 4)])
def test_fold_writes_the_row_major_table(num_basis, F):
    """``lagrange_fold_table`` writes the row-major [C, F/B] table the
    lookups read: the basis contraction of the features-major table,
    transposed, and so is its gradient (a product against a contraction:
    f32 rounding)."""
    rng = np.random.default_rng(F)
    table = torch.from_numpy(rng.standard_normal((F, 777)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((777, F // num_basis))
                         .astype(np.float32))
    t = torch.tensor(0.37)
    outs, grads = [], []
    for fold in (lambda tb: lagrange_fold_table(tb, t, num_basis),
                 lambda tb: torch.tensordot(
                     lagrange_basis(t, num_basis),
                     tb.reshape(num_basis, F // num_basis, -1), dims=1).t()):
        tb = table.clone().requires_grad_(True)
        out = fold(tb)
        out.backward(g)
        outs.append(out.detach())
        grads.append(tb.grad)
    assert outs[0].shape == (777, F // num_basis) and outs[0].is_contiguous()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-6)


def test_kernel_takes_the_cells_widths_on_the_card_only():
    """The kernels take D 2-3, 1-32 features and 1-16 levels;
    ``kernel_refusal`` names what they do not take, which a lookup on the
    card raises for. On the CPU any width runs the plain composition."""
    assert hl.kernel_refusal(3, 8, 4) is None
    assert hl.kernel_refusal(2, 1, 8) is None
    assert hl.kernel_refusal(3, 3, 16) is None
    assert hl.kernel_refusal(2, 32, 1) is None
    assert "F = 33" in hl.kernel_refusal(3, 33, 4)
    assert "17 levels" in hl.kernel_refusal(3, 8, 17)
    assert "D = 4" in hl.kernel_refusal(4, 8, 4)
    planes, S = _planes(3)
    x = _points(np.random.default_rng(0), 9)
    out = hl.hash_lookup([torch.ones(S, 3)], [hl.Query(x, 0, planes)], RES)
    torch.testing.assert_close(out[0], torch.ones(9, 3 * len(RES)))
