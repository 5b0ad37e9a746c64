"""The port's ops against the JAX package on the CPU: segment-add (the
plain version of the B1/B2 kernels), the table gather and its gradient,
multihot sampling (plain version of the B3/B4 kernels) with and without
the weight gradient, occupancy compaction and refresh, and the training
chamfer. Inputs are made with numpy from a seed and handed to both; the
scatters also on the duplicate-heavy keys the CUDA kernels aggregate
(runs of one column, a single column).

Tolerances: forward rtol 1e-4 / atol 1e-5 and gradients atol 1e-4 x
max|reference| — f32 sums taken in another order (XLA's scatter and
reductions against PyTorch's index_add_ and sum) differ by a few ulps of
the sum of magnitudes of their terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nvsf_tpu.ops import chamfer as jchamfer
from nvsf_tpu.ops import multihot as jmh
from nvsf_tpu.ops.gather import table_gather as jgather
from nvsf_tpu.ops.occupancy import OccupancyGridSpec
from nvsf_tpu.ops.segsum import _segment_add_xla
from nvsf_torch.ops import chamfer as tchamfer
from nvsf_torch.ops import kernels
from nvsf_torch.ops import multihot as tmh
from nvsf_torch.ops.gather import table_gather
from nvsf_torch.ops.occupancy import OccupancyGrid
from nvsf_torch.ops.segsum import segment_add_fm

from test_torch_models import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-4, atol=1e-5)


def _grad_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=1e-4 * max(np.abs(ref).max(), 1e-12))


KEY_PATTERNS = ["random", "runs", "one column"]


def _keys(rng, pattern, shape, T):
    """int32 columns in [0, T) of ``shape``: "random"; "runs" of one
    column along the last axis, of random lengths 1-96 (the ray-ordered
    samples of a training step, which the kernels aggregate); or all on
    "one column"."""
    if pattern == "random":
        return rng.integers(0, T, shape).astype(np.int32)
    if pattern == "one column":
        return np.full(shape, T // 3, np.int32)
    n = shape[-1]
    rows = [np.repeat(rng.integers(0, T, n), rng.integers(1, 97, n))[:n]
            for _ in range(int(np.prod(shape[:-1])))]
    return np.stack(rows).reshape(shape).astype(np.int32)


@pytest.mark.parametrize("keys", KEY_PATTERNS)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_segment_add_matches_scatter(precision, keys):
    rng = np.random.default_rng(0)
    T, M, F = 3000, 20000, 8
    cols = _keys(rng, keys, (M,), T)
    vals = rng.standard_normal((F, M)).astype(np.float32)
    ref_vals = jnp.asarray(vals)
    if precision == "bf16":   # the TPU kernel's rounding of each update
        ref_vals = ref_vals.astype(jnp.bfloat16).astype(jnp.float32)
    ref = _segment_add_xla(jnp.asarray(cols), ref_vals, T)
    before = dict(kernels.LAUNCHES)
    got = segment_add_fm(torch.from_numpy(cols), torch.from_numpy(vals), T,
                         precision)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    assert kernels.LAUNCHES == before   # CPU tensors take the plain path


def test_segment_add_reads_column_slices():
    """The gather's prefix gradient passes vals[:, :n] without a copy."""
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.standard_normal((4, 500)).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, 64, 300).astype(np.int32))
    got = segment_add_fm(cols, vals[:, :300], 64, "f32")
    ref = _segment_add_xla(jnp.asarray(cols.numpy()),
                           jnp.asarray(vals[:, :300].numpy()), 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("layout", ["features_major", "row_major_view"])
def test_table_gather_matches_jax_grad(layout):
    """A features-major [F, T] table, or the ``.t()`` view of a row-major
    [T, F] one, as the plain hash lookup reads its tables
    (``ops/hash_lookup.py::lookup_plain``): the gradient reaches the
    row-major tensor transposed."""
    rng = np.random.default_rng(2)
    F, T, M = 4, 600, 2000
    table = rng.standard_normal((F, T)).astype(np.float32)
    cols = rng.integers(0, T, M).astype(np.int32)
    ct = rng.standard_normal((F, M)).astype(np.float32)

    def jloss(tb):
        return jnp.sum(jgather(tb, jnp.asarray(cols)) * ct)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(table))
    if layout == "features_major":
        leaf = torch.from_numpy(table).requires_grad_(True)
        t = leaf
    else:
        leaf = torch.from_numpy(table.T.copy()).requires_grad_(True)
        t = leaf.t()
    out = table_gather(t, torch.from_numpy(cols), precision="f32")
    np.testing.assert_array_equal(out.detach().numpy(),
                                  table[:, cols])
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(float(out.mul(torch.from_numpy(ct)).sum()),
                               float(jv), rtol=1e-4)
    grad = leaf.grad if layout == "features_major" else leaf.grad.t()
    _grad_close(grad.numpy(), jg)


def _multihot_inputs(seed, Q=2, S=3, C=4, W=64, F=4, Np=300,
                     keys="random"):
    rng = np.random.default_rng(seed)
    tables = rng.standard_normal((F, Q * S * W)).astype(np.float32)
    cols = _keys(rng, keys, (Q, S, C, Np), W)
    ws = rng.uniform(0, 1, (Q, S, C, Np)).astype(np.float32)
    g = rng.standard_normal((Q, S, F, Np)).astype(np.float32)
    return tables, cols, ws, g


def _multihot_against_jax(tables, cols, ws, g, W, need_dw):
    """The port's multihot_sample (the plain forward and backward on CPU
    tensors) against the JAX reference's XLA path, which is what its CPU
    tests run."""
    ref_out = jmh.multihot_sample(jnp.asarray(tables), jnp.asarray(cols),
                                  jnp.asarray(ws), W, use_pallas=False,
                                  need_dw=need_dw)
    _, vjp = jax.vjp(lambda tb, w: jmh.multihot_sample(
        tb, jnp.asarray(cols), w, W, use_pallas=False, need_dw=need_dw),
        jnp.asarray(tables), jnp.asarray(ws))
    ref_dt, ref_dw = vjp(jnp.asarray(g))

    tt = torch.from_numpy(tables).requires_grad_(True)
    tw = torch.from_numpy(ws).requires_grad_(True)
    before = dict(kernels.LAUNCHES)
    out = tmh.multihot_sample(tt, torch.from_numpy(cols), tw, W,
                              need_dw=need_dw)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **FWD)
    out.backward(torch.from_numpy(g))
    assert kernels.LAUNCHES == before   # CPU tensors take the plain path
    _grad_close(tt.grad.numpy(), ref_dt)
    if need_dw:
        _grad_close(tw.grad.numpy(), ref_dw)
    else:
        assert not tw.grad.any() and not np.asarray(ref_dw).any()


@pytest.mark.parametrize("keys", KEY_PATTERNS)
@pytest.mark.parametrize("need_dw", [True, False], ids=["dw", "table-only"])
def test_multihot_matches_jax(need_dw, keys):
    W = 64
    tables, cols, ws, g = _multihot_inputs(3, W=W, keys=keys)
    _multihot_against_jax(tables, cols, ws, g, W, need_dw)


# The two plane geometries of the field at toy sizes: the coarse static
# planes (4 bilinear corners of a 4 x 6 plane in a table padded to W = 32
# columns, as planes.py pads them to MULTIHOT_MAX_W) and the folded dynamic
# planes (Q = 3 time queries, x-lerp corners x0 and x0 + 1 of a 16-wide
# row). (Q, S, C, W, columns the corners reach)
MULTIHOT_GEOMETRIES = {"static-padded": (1, 3, 4, 32, 24),
                       "dynamic-lerp": (3, 4, 2, 16, 16)}


@pytest.mark.parametrize("Np", [256, 301])
@pytest.mark.parametrize("need_dw", [True, False], ids=["dw", "table-only"])
@pytest.mark.parametrize("geometry", list(MULTIHOT_GEOMETRIES))
def test_multihot_matches_jax_at_plane_geometries(geometry, need_dw, Np):
    """The edges the CUDA forward's vector and scalar paths care about:
    Np a multiple of 4 and not, columns at 0 and at W - 1 (in the padding
    for the static planes), lerp corners on neighbouring columns."""
    Q, S, C, W, used = MULTIHOT_GEOMETRIES[geometry]
    F = 4
    rng = np.random.default_rng(9)
    tables = rng.standard_normal((F, Q * S * W)).astype(np.float32)
    if C == 2:
        x0 = rng.integers(0, used - 1, (Q, S, 1, Np))
        x0[..., 0], x0[..., 1] = 0, W - 2
        wx = rng.uniform(0, 1, (Q, S, 1, Np))
        cols = np.concatenate([x0, x0 + 1], axis=2)
        ws = np.concatenate([1 - wx, wx], axis=2)
    else:
        cols = rng.integers(0, used, (Q, S, C, Np))
        cols[..., 0], cols[..., 1] = 0, W - 1
        ws = rng.uniform(0, 1, (Q, S, C, Np))
    g = rng.standard_normal((Q, S, F, Np)).astype(np.float32)
    _multihot_against_jax(tables, cols.astype(np.int32),
                          ws.astype(np.float32), g, W, need_dw)


def test_multihot_plain_backward_matches_autograd():
    """The explicit plain backward (what the CUDA kernel is compared with
    on the card) equals autograd through the plain forward."""
    W = 32
    tables, cols, ws, g = _multihot_inputs(4, Q=3, S=2, C=2, W=W)
    tt = torch.from_numpy(tables).requires_grad_(True)
    tw = torch.from_numpy(ws).requires_grad_(True)
    tmh.multihot_fwd_plain(tt, torch.from_numpy(cols), tw, W).backward(
        torch.from_numpy(g))
    dt, dw = tmh.multihot_bwd_plain(torch.from_numpy(tables),
                                    torch.from_numpy(cols),
                                    torch.from_numpy(ws),
                                    torch.from_numpy(g), W, True)
    np.testing.assert_allclose(dt.numpy(), tt.grad.numpy(), **FWD)
    np.testing.assert_allclose(dw.numpy(), tw.grad.numpy(), **FWD)


def test_occupancy_compaction_matches_jax():
    """A random grid (same positions on both sides, so no cell can flip)
    with rays that see between 0 and T occupied candidates."""
    rng = np.random.default_rng(5)
    G, N, T, K = 16, 64, 48, 12
    grid = np.where(rng.uniform(size=(G, G, G)) < 0.4, 5.0,
                    0.0).astype(np.float32)
    ro = rng.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    rd = rng.standard_normal((N, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(0.01, 1.2, (N, T)), -1).astype(np.float32)
    grid[:2] = 0.0
    jspec = OccupancyGridSpec(grid_size=G)
    tspec = OccupancyGrid(grid_size=G)
    jz, jv = jspec.compact_samples(jnp.asarray(grid), jnp.asarray(ro),
                                   jnp.asarray(rd), jnp.asarray(z), K, 1.0)
    tz, tv = tspec.compact_samples(*map(torch.from_numpy,
                                        (grid, ro, rd, z)), K, 1.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    m = np.asarray(jv).sum(-1)
    assert (m == 0).any() and (m == K).any() and ((m > 0) & (m < K)).any()


def test_occupancy_update_matches_jax():
    """One refresh with the JAX draws (unique cells: duplicate writes land
    in an unspecified order in both frameworks) and a density function
    shared as numpy."""
    G = 16
    jspec = OccupancyGridSpec(grid_size=G, update_fraction=4)
    tspec = OccupancyGrid(grid_size=G, update_fraction=4)
    M = G ** 3 // 4
    rng = np.random.default_rng(6)
    cells = rng.permutation(G ** 3)[:M].astype(np.int32)
    u = rng.uniform(size=(M, 3)).astype(np.float32)
    grid = rng.uniform(0, 10, (G, G, G)).astype(np.float32)
    times = np.array([0.1, 0.6], np.float32)
    key = jax.random.PRNGKey(3)
    # feed the same draws to JAX by patching its two draw calls
    orig_randint, orig_uniform = jax.random.randint, jax.random.uniform
    try:
        jax.random.randint = lambda *a, **k: jnp.asarray(cells)
        jax.random.uniform = lambda *a, **k: jnp.asarray(u)
        ref = jspec.update(jnp.asarray(grid), key,
                           lambda p, t: jnp.abs(jnp.sin(7 * p).sum(-1))
                           * (1 + t), times=jnp.asarray(times))
    finally:
        jax.random.randint, jax.random.uniform = orig_randint, orig_uniform
    got = tspec.update(torch.from_numpy(grid),
                       lambda p, t: torch.abs(torch.sin(7 * p).sum(-1))
                       * (1 + t), torch.from_numpy(times),
                       cells=torch.from_numpy(cells),
                       jitter_u=torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_matches_jax(masked):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((300, 3)).astype(np.float32)
    b = rng.standard_normal((200, 3)).astype(np.float32)
    am = rng.uniform(size=300) < 0.8 if masked else None
    bm = rng.uniform(size=200) < 0.8 if masked else None

    def jloss(x):
        d1, d2 = jchamfer.chamfer_distance(
            x, jnp.asarray(b), None if am is None else jnp.asarray(am),
            None if bm is None else jnp.asarray(bm), block_m=64,
            use_pallas=False)
        return jnp.sum(d1) + 2.0 * jnp.sum(d2)

    jv, jg = jax.value_and_grad(jloss)(jnp.asarray(a))
    ta = torch.from_numpy(a).requires_grad_(True)
    d1, d2 = tchamfer.chamfer_distance(
        ta, torch.from_numpy(b), None if am is None else torch.from_numpy(am),
        None if bm is None else torch.from_numpy(bm), block_m=64,
        use_kernel=False)
    v = d1.sum() + 2.0 * d2.sum()
    v.backward()
    np.testing.assert_allclose(float(v), float(jv), rtol=1e-4)
    _grad_close(ta.grad.numpy(), jg)


# ----------------------------------------------------------------------
# B5: the eval chamfer (plain version of the kernel on the CPU)
# ----------------------------------------------------------------------

def _b5_tol(a, b):
    """Per-query bound on the difference of two f32 evaluations of
    min_j |a|^2 + |b_j|^2 - 2 a.b_j: each rounds its squares, its 3-term
    dot product and its two additions, ~10 * 2^-24 * (|a_i|^2 + |b_j|^2)
    apiece, and the min of two lists differs by at most the largest
    difference of their entries; c = 32 leaves room for the summation
    order of either side's matrix product."""
    return 32 * 2.0 ** -24 * ((a * a).sum(-1) + (b * b).sum(-1).max())


@pytest.fixture
def _pallas_interpret():
    from jax.experimental.pallas import tpu as pltpu
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("case", ["dense", "masked", "b_empty", "a_empty"])
def test_chamfer_kernel_plain_matches_jax(case, _pallas_interpret):
    """``chamfer_distance`` on CPU tensors (the B5 plain version) against
    the JAX package's XLA path and its Pallas kernel in interpret mode, at
    N and M that are multiples of no block size, in metres-scale clouds."""
    from nvsf_tpu.ops import chamfer_pallas as jcp
    rng = np.random.default_rng(8)
    N, M = 301, 187
    a = (rng.standard_normal((N, 3)) * 20).astype(np.float32)
    b = (a[rng.integers(0, N, M)] + rng.standard_normal((M, 3))) \
        .astype(np.float32)
    am = bm = None
    if case != "dense":
        am = rng.uniform(size=N) < 0.9
        bm = rng.uniform(size=M) < 0.9
    if case == "b_empty":
        bm[:] = False
    if case == "a_empty":
        am[:] = False
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tam = None if am is None else torch.from_numpy(am)
    tbm = None if bm is None else torch.from_numpy(bm)
    n0 = kernels.LAUNCHES["chamfer_min_dist"]
    d1, d2 = tchamfer.chamfer_distance(ta, tb, tam, tbm, block_m=64)
    assert kernels.LAUNCHES["chamfer_min_dist"] == n0   # CPU: no kernel
    jam = None if am is None else jnp.asarray(am)
    jbm = None if bm is None else jnp.asarray(bm)
    refs = [jchamfer.chamfer_distance(jnp.asarray(a), jnp.asarray(b), jam,
                                      jbm, block_m=64, use_pallas=False),
            jcp.chamfer_distance_pallas(jnp.asarray(a), jnp.asarray(b), jam,
                                        jbm, block_n=64, block_m=128)]
    for r1, r2 in refs:
        np.testing.assert_array_less(np.abs(d1.numpy() - np.asarray(r1)),
                                     _b5_tol(a, b) + 1e-30)
        np.testing.assert_array_less(np.abs(d2.numpy() - np.asarray(r2)),
                                     _b5_tol(b, a) + 1e-30)
    if case == "b_empty":        # no valid b: 1e10 as where(mask, d2, 1e10)
        assert (d1.numpy()[am] == 1e10).all()
    if case == "a_empty":
        assert (d1.numpy() == 0).all() and (d2.numpy()[bm] == 1e10).all()
    one = tchamfer.min_dist2_plain(ta, tb, tbm, block_m=64)
    np.testing.assert_array_equal(
        np.where(am if am is not None else True, one.numpy(), 0.0),
        d1.numpy())


def test_chamfer_kernel_refuses_cpu_tensors():
    """The kernel's wrapper never runs on CPU tensors; the training path
    keeps its gradient."""
    a = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tchamfer.min_dist2_cuda(a, a)
    x = torch.randn((5, 3), requires_grad=True)
    d1, _ = tchamfer.chamfer_distance(x, torch.randn((7, 3)),
                                      use_kernel=False)
    assert d1.requires_grad
    d1, _ = tchamfer.chamfer_distance(x, torch.randn((7, 3)))
    assert not d1.requires_grad
