"""The port's CUDA kernels against their plain PyTorch versions, one
training step and one eval through them, the captured step against the
eager step, and the captured frame renders (``render/frame_graph.py``,
the marcher's slab loop as conditional IF nodes) against eager renders on
the card. These need an NVIDIA GPU with nvcc and skip without one; on the
card run them without the JAX test setup:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The hash-grid lookup (``csrc/hash_encode.cu`` and its gradient in B1's
rows stage) is held to its plain composition at each cell's encoder shapes
and at two other feature counts on ray-ordered points, and replayed in a
CUDA graph.

The scatter kernels (B1, B4) are also held to their plain versions on the
key patterns their warp aggregation and vector atomics are built for:
runs of one column, a single column, dropped columns, ragged sizes. The
forward (B3) is held to its plain version on each of its paths (vector or
scalar, F = 8 or any F), at the step's and the render's shapes.

Tolerance: a kernel's f32 sums run in another order than the plain
version's (atomics land in any order), so each output is held to 1e-5 of
the sum of the magnitudes of its terms. The chamfer kernel (B5) is held to
32 * 2^-24 * (|a_i|^2 + max_j |b_j|^2) per query, the rounding of two f32
evaluations of |a|^2 + |b|^2 - 2 a.b (see ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from nvsf_torch.ops import chamfer
from nvsf_torch.ops import hash_lookup as hl
from nvsf_torch.ops import kernels
from nvsf_torch.ops import multihot as mh
from nvsf_torch.ops import segsum

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, ref, bound):
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(bound.abs().max()) + 1e-7, err


KEY_PATTERNS = ["random", "runs", "one column", "out of range"]


def _keys(rng, pattern, shape, T):
    """int32 columns of ``shape`` (numpy): "random" in [0, T); "runs" of
    one column along the last axis, of random lengths 1-96 (the ray-ordered
    samples of a training step, which the kernels aggregate in a warp); all
    on "one column"; or "out of range": random in [-T/4, 5T/4), a fifth
    of them outside [0, T) and dropped by the kernels."""
    if pattern == "random":
        return rng.integers(0, T, shape).astype(np.int32)
    if pattern == "one column":
        return np.full(shape, T // 3, np.int32)
    if pattern == "out of range":
        return rng.integers(-(T // 4), T + T // 4, shape).astype(np.int32)
    n = shape[-1]
    rows = [np.repeat(rng.integers(0, T, n), rng.integers(1, 97, n))[:n]
            for _ in range(int(np.prod(shape[:-1])))]
    return np.stack(rows).reshape(shape).astype(np.int32)


@pytest.mark.parametrize("F", [1, 2, 3, 8])
@pytest.mark.parametrize("keys", KEY_PATTERNS)
@pytest.mark.parametrize("precision", ["bf16", "f32"])
def test_segment_add_kernel(dev, precision, keys, F):
    """B1/B2 against the plain version: M a multiple of neither a warp nor
    a block, vals a column slice of a wider tensor (row stride > M), F on
    the in-place (1), float2 (2), scalar (3) and float4 (8) paths of the
    kernel."""
    rng = np.random.default_rng(0)
    T, M = 50_000, 400_003
    cols = torch.from_numpy(_keys(rng, keys, (M,), T)).to(dev)
    vals = torch.from_numpy(rng.standard_normal((F, M + 100))
                            .astype(np.float32)).to(dev)[:, :M]
    n0 = kernels.LAUNCHES["segment_add"]
    got = segsum.segment_add_fm(cols, vals, T, precision)
    assert kernels.LAUNCHES["segment_add"] == n0 + 1
    keep = (cols >= 0) & (cols < T)     # the plain version cannot drop
    kc, kv = cols[keep], vals[:, keep]
    ref = segsum.segment_add_plain(kc, kv, T, precision)
    _close(got, ref, segsum.segment_add_plain(kc, kv.abs(), T, "f32"))


@pytest.mark.parametrize("F", [8, 4])
@pytest.mark.parametrize("keys", KEY_PATTERNS)
@pytest.mark.parametrize("need_dw", [True, False], ids=["dw", "table-only"])
@pytest.mark.parametrize("shape", [(1, 6, 4, 4096), (3, 12, 2, 256)],
                         ids=["static-coarse", "dynamic"])
def test_multihot_kernels(dev, shape, need_dw, keys, F):
    """B3 and B4 against the plain versions at both plane shapes, with
    and without the weight gradient, Np a multiple of no warp, F on the
    backward's F = 8 path (the step's) and its path for any other F. Columns
    outside [0, W) contribute nothing in the kernels: the reference
    clamps them and zeroes their weights and weight gradients. The plain
    versions run in f64: on "one column" a slot sums 80k terms, which an
    f32 sum taken term by term rounds by more than the kernel's sum in
    warp runs."""
    Q, S, C, W = shape
    Np = 20_011
    rng = np.random.default_rng(1)
    cols_np = _keys(rng, keys, (Q, S, C, Np), W)
    tables, ws, gr = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.uniform(0, 1, (F, Q * S * W)), rng.uniform(0, 1, (Q, S, C, Np)),
        rng.standard_normal((Q, S, F, Np))))
    cols = torch.from_numpy(cols_np).to(dev)
    ok = (cols >= 0) & (cols < W)
    rc, rw = cols.clamp(0, W - 1), torch.where(ok, ws, 0.0)
    t64, w64 = tables.double(), rw.double()
    out = mh.multihot_fwd_cuda(tables, cols, ws, W)
    ref = mh.multihot_fwd_plain(t64, rc, w64, W)
    _close(out, ref, ref)
    dt, dw = mh.multihot_bwd_cuda(tables, cols, ws, gr, W, need_dw)
    rdt, rdw = mh.multihot_bwd_plain(t64, rc, w64, gr.double(), W, need_dw)
    bdt, bdw = mh.multihot_bwd_plain(tables, rc, rw, gr.abs(), W, need_dw)
    _close(dt, rdt, bdt)
    if need_dw:
        _close(dw, torch.where(ok, rdw, 0.0), bdw)
    else:
        assert dw is None


# (Q, S, C, W) of the forward tests: one segment with one corner; the
# static planes (6 segments, 4 corners, W 4096); the dynamic planes at one
# time (12 segments, 2 lerp corners, W 256; the occupancy refresh's query)
# and at the warp's three times (Q*S 36; the step's and the render's);
# 4 segments of 4 corners in a narrow table.
FWD_SHAPES = {"one-segment": (1, 1, 1, 256), "static": (1, 6, 4, 4096),
              "dynamic-one-time": (1, 12, 2, 256),
              "dynamic-warp": (3, 12, 2, 256), "narrow": (2, 2, 4, 256)}
# every shape with every F whose segment (F * W floats) fits in a block's
# shared memory: all but F 16 at W 4096
FWD_CASES = [(shape, F) for shape in FWD_SHAPES for F in (3, 4, 8, 16)
             if F * FWD_SHAPES[shape][3] * 4 <= 232448]


@pytest.mark.parametrize("keys", KEY_PATTERNS)
@pytest.mark.parametrize("Np", [1, 31, 20_011, 32_768])
@pytest.mark.parametrize("shape,F", FWD_CASES)
def test_multihot_fwd_kernel(dev, shape, F, Np, keys):
    """B3 against its plain version in f64 on every path of the kernel:
    Np on the 4-sample vector path (32,768, the render's slab of 2,048 rays
    x 16 samples) and the scalar one (1, 31, 20,011), F on the F = 8 path
    and the generic one, columns at 0, at W - 1 and outside [0, W), which
    contribute nothing."""
    Q, S, C, W = FWD_SHAPES[shape]
    rng = np.random.default_rng(2)
    cols_np = _keys(rng, keys, (Q, S, C, Np), W)
    cols_np[..., 0], cols_np[..., -1] = 0, W - 1
    tables, ws = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.uniform(-1, 1, (F, Q * S * W)), rng.uniform(0, 1, (Q, S, C, Np))))
    cols = torch.from_numpy(cols_np).to(dev)
    ok = (cols >= 0) & (cols < W)
    rc, rw = cols.clamp(0, W - 1), torch.where(ok, ws, 0.0)
    n0 = kernels.LAUNCHES["multihot_fwd"]
    out = mh.multihot_fwd_cuda(tables, cols, ws, W)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["multihot_fwd"] == n0 + 1
    ref = mh.multihot_fwd_plain(tables.double(), rc, rw.double(), W)
    _close(out, ref, mh.multihot_fwd_plain(tables.abs(), rc, rw, W))


@pytest.mark.parametrize("F,W", [(16, 4096), (8, 8192)])
def test_multihot_rejects_segments_over_shared_memory(dev, F, W):
    """A segment of F * W floats over a block's 227 KB of shared memory,
    which both kernels hold whole, is refused before any launch."""
    Q, S, C, Np = 1, 2, 4, 64
    tables = torch.zeros((F, Q * S * W), device=dev)
    cols = torch.zeros((Q, S, C, Np), dtype=torch.int32, device=dev)
    ws = torch.ones((Q, S, C, Np), device=dev)
    g = torch.ones((Q, S, F, Np), device=dev)
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="227 KB"):
        mh.multihot_fwd_cuda(tables, cols, ws, W)
    with pytest.raises(ValueError, match="227 KB"):
        mh.multihot_bwd_cuda(tables, cols, ws, g, W, True)
    assert kernels.LAUNCHES == n0


@pytest.mark.parametrize("masked", [False, True])
def test_chamfer_kernel(dev, masked):
    g = torch.Generator(device=dev).manual_seed(2)
    N, M = 20_011, 13_007
    a = torch.randn((N, 3), generator=g, device=dev) * 30
    b = a[torch.randint(0, N, (M,), generator=g, device=dev)] \
        + torch.randn((M, 3), generator=g, device=dev)
    am = bm = None
    if masked:
        am = torch.rand(N, generator=g, device=dev) < 0.9
        bm = torch.rand(M, generator=g, device=dev) < 0.9
    n0 = kernels.LAUNCHES["chamfer_min_dist"]
    d1, d2 = chamfer.chamfer_distance(a, b, am, bm)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["chamfer_min_dist"] == n0 + 2
    for got, x, y, ym, xm in ((d1, a, b, bm, am), (d2, b, a, am, bm)):
        ref = chamfer.min_dist2_plain(x, y, ym)
        if xm is not None:
            ref = torch.where(xm, ref, 0.0)
        tol = 32 * 2.0 ** -24 * ((x * x).sum(-1) + (y * y).sum(-1).max())
        assert bool(((got - ref).abs() <= tol).all())


# ----------------------------------------------------------------------
# the hash-grid lookup (ops/hash_lookup.py)
# ----------------------------------------------------------------------

# (D, F, levels, base and max resolution, log2 T of each plane): the
# encoders of the benchmark's occupancy cell (hash 4 x 8, flow 4 x 32 over
# 4 bases) and dense cell (hash 8 x 4, flow 16 x 8); the dynamic tables
# folded over 4 bases; and two feature counts that no cell has, which run
# the kernels' runtime-F instantiations
HASH_CASES = {
    "runtime F 3D": (3, 3, 8, 16, 4096, (17,)),
    "runtime F 2D": (2, 16, 4, 16, 2048, (12, 11, 11)),
    "occ static": (3, 8, 4, 512, 32768, (19,)),
    "occ dynamic": (2, 2, 4, 512, 32768, (15, 13, 13)),
    "occ flow": (3, 8, 4, 32, 8192, (18,)),
    "dense static": (3, 4, 8, 512, 32768, (19,)),
    "dense dynamic": (2, 1, 8, 512, 32768, (15, 13, 13)),
    "dense flow": (3, 2, 16, 32, 8192, (18,)),
}
PLANE_AXES = ((0, 1), (0, 2), (1, 2))


def _ray_points(gen, n, dev, steps=96):
    """n points in [0, 1]^3 along rays of ``steps`` samples each (the
    step's ray order), with points on the faces 0 and 1."""
    rays = -(-n // steps)
    o = torch.rand((rays, 1, 3), generator=gen, device=dev) * 0.4 + 0.3
    d = torch.nn.functional.normalize(
        torch.randn((rays, 1, 3), generator=gen, device=dev), dim=-1)
    z = torch.linspace(0, 0.5, steps, device=dev)[None, :, None]
    x = (o + d * z).reshape(-1, 3)[:n].clamp(0, 1).contiguous()
    x[:7] = 1.0
    x[7:11] = 0.0
    return x


def _hash_case(name, gen, dev, n=196_608):
    """(tables, queries, resolutions) of one case: one table and one
    query, its points a column slice of [n, 4] (the flow's xyz + t)."""
    from nvsf_torch.models.hash_grid import level_resolutions
    D, F, L, base, top, log2s = HASH_CASES[name]
    res = level_resolutions(base, top, L)
    planes, slot0 = [], 0
    for i, lg in enumerate(log2s):
        planes.append(hl.Plane(PLANE_AXES[i] if D == 2 else (0, 1, 2),
                               slot0, lg))
        slot0 += L << lg
    table = torch.rand((F, slot0), generator=gen, device=dev) * 2 - 1
    xt = torch.cat([_ray_points(gen, n, dev), torch.full((n, 1), 0.3,
                                                         device=dev)], -1)
    return table, [hl.Query(xt[:, :3], 0, tuple(planes))], res


def _plain_table_grad(table, queries, gs, res, precision):
    """The table gradient in plain PyTorch, and the same sum of the
    updates' magnitudes (the tolerance's scale)."""
    cols, vals = [], []
    for q, g in zip(queries, gs):
        for p, pl in enumerate(q.planes):
            c, wc = hl.level_cols_weights(q.x[:, list(pl.axes)], res,
                                          1 << pl.log2_T)
            L, C, N = wc.shape
            F = table.shape[0]
            gp = g[:, p * L * F:(p + 1) * L * F].reshape(N, L, F)
            cols.append(c + pl.slot0)
            vals.append((gp.permute(2, 1, 0)[:, :, None, :] * wc[None])
                        .reshape(F, -1))
    cols, vals = torch.cat(cols), torch.cat(vals, 1)
    S = table.shape[1]
    return (segsum.segment_add_plain(cols, vals, S, precision),
            segsum.segment_add_plain(cols, vals.abs(), S, "f32"))


@pytest.mark.parametrize("precision", ["bf16", "f32"])
@pytest.mark.parametrize("case", list(HASH_CASES))
def test_hash_lookup_kernels(dev, case, precision):
    """The lookup's forward and table gradient against the plain
    composition at each cell's encoder shape: the forward within 1e-5 of
    the sum of |w v| (the same lookup of |table|), the gradient within
    1e-5 of the sum of its updates' magnitudes; the features-major table
    (a parameter, read as ``param.t()``) and the row-major one (a fold's
    output) alike, each taking its gradient in its own layout; every
    launch a kernel's."""
    gen = torch.Generator(device=dev).manual_seed(3)
    table, queries, res = _hash_case(case, gen, dev)
    ref = hl.lookup_plain([table.t()], queries, res)[0]
    bound = hl.lookup_plain([table.abs().t()], queries, res)[0]
    g = torch.randn(ref.shape, generator=gen, device=dev)
    ref_grad, grad_bound = _plain_table_grad(table, queries, [g], res,
                                             precision)
    for rows in (False, True):
        t = (table.t().contiguous() if rows else table.clone()) \
            .requires_grad_(True)
        kernels.reset_launch_counts()
        out = hl.hash_lookup([t if rows else t.t()], queries, res,
                             precision)[0]
        out.backward(g)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["hash_encode_fwd"] == 1 and counts["hash_encode_bwd"] \
            == 1 and counts["segment_add"] == 0, counts
        assert t.grad.shape == t.shape and t.grad.is_contiguous()
        _close(out, ref, bound)
        _close(t.grad.t() if rows else t.grad, ref_grad, grad_bound)


def test_hash_lookup_refuses_what_the_kernels_do_not_take(dev):
    """On the card a lookup the kernels cannot take raises; none runs the
    plain composition."""
    gen = torch.Generator(device=dev).manual_seed(3)
    _, queries, res = _hash_case("occ static", gen, dev, n=1024)
    with pytest.raises(ValueError, match="F = 33"):
        hl.hash_lookup([torch.zeros((2 ** 21, 33), device=dev)], queries,
                       res)


def test_hash_lookup_graph_replay_matches_eager(dev):
    """The occupancy cell's lookups of one branch (static, the dynamic
    t-query with gradient and both warp queries without, the flow field's)
    captured in one CUDA graph with their gradients, replayed on new
    points and tables, equal to eager calls (within the atomics' order);
    every lookup ran the kernels."""
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = [_hash_case(c, gen, dev, n=65_536) for c in
             ("occ static", "occ dynamic", "occ flow")]
    params = [t.requires_grad_(True) for t, _, _ in cases]
    xs = [q[0].x.clone() for _, q, _ in cases]
    warps = [xs[1] + 0.01, xs[1] - 0.01]

    def step():
        outs = []
        for i, (p, (_, q, res)) in enumerate(zip(params, cases)):
            qq = [hl.Query(xs[i], 0, q[0].planes)]
            outs += hl.hash_lookup([p.t()], qq, res, "bf16")
        _, q, res = cases[1]
        with torch.no_grad():
            outs += hl.hash_lookup(
                [params[1].t()] * 2,
                [hl.Query(w, i, q[0].planes) for i, w in enumerate(warps)],
                res)
        loss = sum((o * o.sum(-1, keepdim=True)).sum() for o in outs)
        return [o.detach() for o in outs] + list(
            torch.autograd.grad(loss, params))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        step()                      # warm-up
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    kernels.reset_launch_counts()
    with torch.cuda.graph(graph):
        static_out = step()
    counts = kernels.launch_counts()
    assert counts["hash_encode_fwd"] == 4 and counts["hash_encode_bwd"] \
        == 3 and counts["segment_add"] == 0, counts
    for _ in range(2):
        with torch.no_grad():
            for x in xs + warps:
                x.copy_(x.roll(1000, 0))
            for p in params:
                p.mul_(-1.5)
        graph.replay()
        eager = step()
        for got, ref in zip(static_out, eager):
            _close(got, ref, ref)


def test_training_step_launches_every_kernel(dev):
    """Two steps of the joint trainer at toy size run through the hash
    lookup's kernels (its gradient B1's rows stage), B3 and B4 and leave
    finite parameters; an eval of the trained field runs through B3 and
    B5."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer

    spec = SyntheticSceneSpec(num_frames=4, H_lidar=24, W_lidar=64, H=32,
                              W=40, max_depth=80.0, scale=1 / 81)
    s = spec.scale
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=4, scale=s, bound=1.0,
        min_near_lidar=s, lidar_max_depth=80 * s, min_near=s,
        active_sensor=True, num_rays=256, num_rays_lidar=256, num_steps=64,
        num_steps_occ=32, render_mode="occupancy", log2_hashmap_size=14,
        n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
        flow_n_features_per_level=32, iters=100, fp16=True, flow_loss=True,
        use_urf_loss=True, use_error_map=True))
    tr = Trainer(cfg, make_synthetic_scene(spec))
    assert tr.device.type == "cuda"
    kernels.reset_launch_counts()
    for patch in (False, True):
        m = tr.train_step(0, patch)
        assert np.isfinite(float(m["loss"]))
    torch.cuda.synchronize()
    step = ("multihot_fwd", "multihot_bwd", "hash_encode_fwd",
            "hash_encode_bwd")
    assert all(kernels.LAUNCHES[k] > 0 for k in step), kernels.LAUNCHES
    # every table gradient of the step is a hash lookup's fused one: none
    # ran B1's cols/vals entry (the plain composition's)
    assert kernels.LAUNCHES["segment_add"] == 0, kernels.LAUNCHES
    assert all(torch.isfinite(p).all() for p in tr.field.parameters())

    from nvsf_torch.train.evaluate import evaluate
    kernels.reset_launch_counts()
    evaluate(tr, make_synthetic_scene(spec, split="val"), log_fn=None)
    # two launches per category whose clouds are not empty: at two steps
    # the field may predict no point of the foreground object; the
    # render's B3 launches run in IF nodes, counted on the device
    launches = kernels.launch_counts()
    assert launches["chamfer_min_dist"] >= 2
    assert launches["multihot_fwd"] > 0
    assert launches["segment_add"] == 0


# ----------------------------------------------------------------------
# the captured step (train/step_graph.py) against the eager step
# ----------------------------------------------------------------------

def _graph_pair(interval=2):
    """Two toy f32 occupancy trainers from one seed, their grids with an
    empty half-space (a refresh then changes what the compaction keeps)."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer

    spec = SyntheticSceneSpec(num_frames=5, H_lidar=24, W_lidar=64, H=32,
                              W=40, max_depth=80.0, scale=1 / 81)
    s = spec.scale
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=5, scale=s, bound=1.0,
        min_near_lidar=s, lidar_max_depth=80 * s, min_near=s,
        active_sensor=True, num_rays=256, num_rays_lidar=256, num_steps=64,
        num_steps_occ=32, render_mode="occupancy", log2_hashmap_size=14,
        n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
        iters=100, flow_loss=True, use_urf_loss=True, use_error_map=True,
        occ_grid_size=32, occ_update_interval=interval))
    scene = make_synthetic_scene(spec)
    g, e = Trainer(cfg, scene), Trainer(cfg, scene)
    with torch.no_grad():
        for grid in (g.occ_grid_lidar, g.occ_grid_rgb):
            grid[:, :, :12] = 0.0
    return g, e


@torch.no_grad()
def _sync_state(src, dst):
    for p, q in zip(src.field.parameters(), dst.field.parameters()):
        q.copy_(p)
        for k, v in src.optimizer.state.get(p, {}).items():
            dst.optimizer.state[q][k].copy_(v)
    for k in ("occ_grid_lidar", "occ_grid_rgb", "error_map",
              "error_map_rgb"):
        getattr(dst, k).copy_(getattr(src, k))
    dst.generator.set_state(src.generator.get_state())


def test_replayed_steps_match_eager_steps_across_a_refresh(dev):
    """Five f32 steps of one trainer through ``scan_step`` (two eager
    warm-ups, the capture, two replays) against eager steps of a second
    trainer on the same state and generator state: equal losses and
    gradients (1e-5 of each gradient's max: B1/B2 and B4 sum by atomics),
    a grid refresh between the replays read by the next one (the graphed
    trainer's captured refresh, after its eager warm-up, against the eager
    trainer's eager refresh), launches counted per replay."""
    from nvsf_torch.train.step_graph import WARMUP_STEPS
    g, e = _graph_pair()
    refresh = e.refresh_occupancy
    e.refresh_occupancy = lambda seed: refresh(seed, graphed=False)
    counts = {"g": {}, "e": {}}

    def counted(who, fn, *args):
        kernels.reset_launch_counts()
        out = fn(*args)
        for k, n in kernels.LAUNCHES.items():
            counts[who][k] = counts[who].get(k, 0) + n
        return out

    for i, fi in enumerate((0, 1, 2, 3, 0)):
        _sync_state(g, e)
        mg = counted("g", g.scan_step, fi, False)
        me = counted("e", e.train_step, fi, False)
        for k, v in me.items():
            assert abs(float(mg[k]) - float(v)) <= 1e-5 * abs(float(v)), k
        for p, q in zip(e.field.parameters(), g.field.parameters()):
            _close(q.grad, p.grad, p.grad)
        if i % 2 == 1:       # the refresh of interval 2, after steps 2 and 4
            _sync_state(g, e)
            g.maybe_update_occ()
            e.maybe_update_occ()
            assert torch.equal(g.occ_grid_lidar, e.occ_grid_lidar)
    sg = g.step_graphs
    assert list(sg.graphs) == [False] and sg.replays[False] == 5 - WARMUP_STEPS
    assert g.occ_refresh_count == 2 and g.global_step == 5
    prog, = g.programs.values()
    assert (prog.warm, prog.replays) == (1, 1) and not e.programs
    # a replay counts the launches its capture recorded
    assert counts["g"] == counts["e"] and counts["g"]["multihot_bwd"] > 0, \
        counts


def _device_markers(events):
    return [n for n, _, _, on in sorted(events, key=lambda e: e[1])
            if on and "nvsf_span_" in n]


def test_replays_run_the_marker_sequence_of_their_capture(dev):
    """The span markers (``train/profiler.py``, ``csrc/spans.cu``) on the
    captured step: the last eager warm-up (the code the capture records)
    and three replays, traced apart from the capture: each replay runs the
    warm-up's marker kernels in its order, balanced and nested; there
    every B1, B3 and B4 kernel runs inside an ``encode.*`` span; markers
    add nothing to the launch counts. The host's parts of each replayed
    step are its ranges ``nvsf/step.*``, one each a step."""
    from torch.profiler import ProfilerActivity, profile

    from nvsf_torch.train import profiler as P
    from nvsf_torch.train.step_graph import WARMUP_STEPS
    g, _ = _graph_pair(interval=100)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for fi in range(WARMUP_STEPS - 1):
        g.scan_step(fi, False)
    with profile(activities=acts) as prof:
        g.scan_step(0, False)
        torch.cuda.synchronize()
    eager = _device_markers(P.trace_events(prof))
    g.scan_step(1, False)                 # the capture and first replay
    with profile(activities=acts) as prof:
        for fi in (2, 3, 0):
            g.scan_step(fi, False)
        torch.cuda.synchronize()
    events = P.trace_events(prof)
    assert g.step_graphs.replays[False] == 4
    assert eager and _device_markers(events) == eager * 3
    times = P.span_times(events)
    for name in ("sample", "render", "encode.hash", "encode.planes",
                 "encode.flow", "mlp", "loss", "backward", "optim"):
        assert times[name]["opens"] == times[name]["closes"] > 0, name
    stack, outside = [], []
    for n, _, _, on in sorted(events, key=lambda e: e[1]):
        if not on:
            continue
        if n.startswith("nvsf_span_open_"):
            stack.append(n[len("nvsf_span_open_"):])
        elif n.startswith("nvsf_span_close_"):
            assert stack.pop() == n[len("nvsf_span_close_"):]
        elif ("segment_add" in n or "multihot" in n) and not any(
                s.startswith("encode_") for s in stack):
            outside.append(n)
    assert not stack and not outside, outside
    host = [n for n, _, _, on in events
            if not on and n.startswith("nvsf/step.")]
    assert sorted(host) == sorted(
        f"nvsf/step.{p}" for p in ("fill", "hold_grads", "replay",
                                   "end_step") for _ in range(3)), host
    kernels.reset_launch_counts()
    for name in P.SPANS:
        P.mark(name, True, dev)
        P.mark(name, False, dev)
    torch.cuda.synchronize()
    assert not any(kernels.launch_counts().values())


def test_load_checkpoint_drops_the_captured_steps(dev, tmp_path):
    """A load replaces the error maps, grids and Adam moments, so it drops
    the captured steps; the next scanned epoch captures anew and resumes
    the schedule, Adam's step count on the card."""
    g, _ = _graph_pair(interval=16)
    g.cfg.workspace = g.workspace = str(tmp_path)
    g.epoch = 1
    g.train_one_epoch(order=[0, 1, 2, 3])
    assert g.step_graphs is not None and False in g.step_graphs.graphs
    g.save_checkpoint(full=True)
    g.global_step = 0
    assert g.load_checkpoint("latest")
    assert g.step_graphs is None and g.global_step == 4
    p = next(g.field.parameters())
    assert g.optimizer.state[p]["step"].is_cuda
    assert int(g.optimizer.state[p]["step"]) == 4
    g.epoch = 3
    st = g.train_one_epoch(order=[0, 1, 2, 3])
    assert np.isfinite(st.loss) and False in g.step_graphs.graphs
    assert g.global_step == 8
    lr = g.optimizer.param_groups[0]["lr"]
    assert abs(float(lr) - g.cfg.lr * 0.1 ** (8 / 100)) <= 1e-6 * g.cfg.lr


# ----------------------------------------------------------------------
# the captured frame renders (render/frame_graph.py) against eager renders
# ----------------------------------------------------------------------

def _render_trainer(**over):
    """A toy f32 occupancy trainer whose grids are empty above a plane (sky
    chunks exit at once), its frames in several chunks of 512 rays and its
    marcher in 4 slabs of 8 (K 32)."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer

    spec = SyntheticSceneSpec(num_frames=4, H_lidar=24, W_lidar=64, H=32,
                              W=40, max_depth=80.0, scale=1 / 81)
    s = spec.scale
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=4, scale=s, bound=1.0,
        min_near_lidar=s, lidar_max_depth=80 * s, min_near=s,
        active_sensor=True, num_rays=256, num_rays_lidar=256, num_steps=64,
        num_steps_occ=32, render_mode="occupancy", log2_hashmap_size=14,
        n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
        iters=100, occ_grid_size=32, max_ray_batch=512, stream_slab=8,
        density_scale=30.0, **over))
    tr = Trainer(cfg, make_synthetic_scene(spec))
    with torch.no_grad():
        for grid in (tr.occ_grid_lidar, tr.occ_grid_rgb):
            grid[:, :, 20:] = 0.0
        for k, p in tr.field.named_parameters():   # an EMA unlike the field
            tr.ema[k].copy_(p * 0.9)
    return tr


def _eager_frame(tr, rend, fi, lidar, occ):
    """Frame ``fi`` through ``Renderer.render_eager`` on the card, from the
    rays the sweep makes: (outputs, slabs run)."""
    from nvsf_torch.lib import rays as raylib
    scene, dev = tr.scene, tr.device
    if lidar:
        H, W = scene.H_lidar, scene.W_lidar
        ro, rd = raylib.get_lidar_rays(
            torch.as_tensor(scene.poses_lidar[fi], dtype=torch.float32,
                            device=dev),
            torch.arange(H * W, dtype=torch.int32, device=dev), H, W,
            tuple(map(float, scene.intrinsics_lidar)),
            tuple(map(float, scene.intrinsics_hoz_lidar)))
        kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True) if occ else {}
    else:
        H, W = scene.H, scene.W
        ro, rd = raylib.get_camera_rays(
            torch.as_tensor(scene.poses[fi], dtype=torch.float32,
                            device=dev),
            torch.arange(H * W, dtype=torch.int32, device=dev), H, W,
            torch.as_tensor(scene.intrinsics, dtype=torch.float32,
                            device=dev))
        kw = dict(tr._occ_kwargs(tr.occ_grid_rgb) if occ else {},
                  bg_color=1.0)
    rend.slab_counter(dev).zero_()
    out = rend.render_eager(ro, rd, torch.tensor(float(scene.times[fi]),
                                                 device=dev),
                            cal_lidar_color=lidar, **kw)
    return out, int(rend.slabs_run)


def _graphed_frame(tr, rend, fi, lidar, occ):
    """Frame ``fi`` through the sweep, which replays ``rend``'s frame
    graphs: (outputs under the renderer's keys, slabs run)."""
    from nvsf_torch.render import sweep
    scene = tr.scene
    rend.slab_counter(tr.device).zero_()
    if lidar:
        kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True) if occ else None
        o = sweep.render_pano(rend, scene.poses_lidar[fi], scene.times[fi],
                              scene.H_lidar, scene.W_lidar,
                              scene.intrinsics_lidar,
                              scene.intrinsics_hoz_lidar, kw)
        out = {"depth_lidar": o["depth"].reshape(-1),
               "image_lidar": torch.stack([o["raydrop"], o["intensity"]],
                                          -1).reshape(-1, 2)}
    else:
        kw = tr._occ_kwargs(tr.occ_grid_rgb) if occ else None
        o = sweep.render_view(rend, scene.poses[fi], scene.times[fi],
                              scene.H, scene.W, scene.intrinsics, kw)
        out = {"depth": o["depth"].reshape(-1),
               "image": o["rgb"].reshape(-1, 3)}
    return out, int(rend.slabs_run)


def _close_to_max(got, ref, rtol=1e-6):
    for k in ref:
        err = float((got[k] - ref[k]).abs().max())
        assert err <= rtol * float(ref[k].abs().max()) + 1e-12, (k, err)


@pytest.mark.parametrize("occ", [True, False], ids=["occupancy", "dense"])
@pytest.mark.parametrize("lidar", [True, False], ids=["lidar", "camera"])
def test_graphed_frames_match_eager_frames(dev, lidar, occ):
    """Two frames at other poses and times from the live and the EMA
    renderer through their frame graphs, each within 1e-6 of each
    output's max of the eager render (``render_eager``: the same kernels,
    every slab gated on the device) with the same slabs run; the second
    frame renders other values (its pose and time refill the graphs'
    static inputs); each renderer captured each stage once."""
    tr = _render_trainer()
    for rend in (tr.renderer, tr.ema_renderer):
        frames = []
        for fi in (0, 2):
            got, n_got = _graphed_frame(tr, rend, fi, lidar, occ)
            ref, n_ref = _eager_frame(tr, rend, fi, lidar, occ)
            _close_to_max(got, ref)
            assert n_got == n_ref, (n_got, n_ref)
            frames.append(got)
        key = next(iter(frames[0]))
        assert not torch.equal(frames[0][key], frames[1][key])
        fg = rend.frame_graphs
        kinds = sorted(k[0] for k in fg.graphs)
        assert kinds == (["occ-chunk", "occ-post", "occ-pre"] if occ
                         else ["dense-chunk", "dense-pre"]), kinds
    assert tr.renderer.frame_graphs is not tr.ema_renderer.frame_graphs
    live = _graphed_frame(tr, tr.renderer, 0, lidar, occ)[0]
    ema = _graphed_frame(tr, tr.ema_renderer, 0, lidar, occ)[0]
    assert not torch.equal(live[key], ema[key])


def test_frame_graphs_share_pools_and_count_the_slabs_that_ran(dev):
    """The live and the EMA renderer's frame graphs capture into one pair
    of pools, freed with the last of them. A graphed LiDAR frame counts the
    B3 launches of the slabs that the device ran, not of those it skipped:
    its launches over its slabs run equal the eager frame's (every slab
    step issued, gated) over its slab steps, with slabs skipped, and each
    replay counts its IF nodes' own kernels."""
    import gc
    from nvsf_torch.render import frame_graph
    tr = _render_trainer()
    live, ema = tr.renderer, tr.ema_renderer
    _graphed_frame(tr, live, 0, True, True)             # captures
    _graphed_frame(tr, ema, 0, True, True)
    assert live.frame_graphs.pools is ema.frame_graphs.pools
    kernels.reset_launch_counts()
    _, slabs = _graphed_frame(tr, live, 0, True, True)
    graphed = kernels.launch_counts()
    kernels.reset_launch_counts()
    _, n_eager = _eager_frame(tr, live, 0, True, True)
    eager = kernels.launch_counts()
    # 24 x 64 rays in chunks of 512, K 32 in slabs of 8
    steps = -(-tr.scene.H_lidar * tr.scene.W_lidar // 512) * (32 // 8)
    assert slabs == n_eager and 0 < slabs < steps, (slabs, n_eager, steps)
    assert graphed["multihot_fwd"] * steps == eager["multihot_fwd"] * slabs, \
        (graphed, eager, slabs, steps)
    assert graphed["graph_if"] == steps and eager["graph_if"] == 0
    tr.drop_step_graphs()
    gc.collect()
    assert not list(frame_graph._POOLS)


def test_graphed_chunk_is_sync_free_and_reads_the_grid_in_place(dev):
    """``run_occupancy_stream`` of one chunk as a replay against the eager
    chunk (1e-6 of each output's max, the same slabs, at least one slab
    skipped); a second replay under ``set_sync_debug_mode("error")``; a
    grid written in place changes the next replay as it changes the eager
    chunk."""
    tr = _render_trainer()
    rend, scene = tr.renderer, tr.scene
    H, W = scene.H_lidar, scene.W_lidar
    from nvsf_torch.lib import rays as raylib
    ro, rd = raylib.get_lidar_rays(
        torch.as_tensor(scene.poses_lidar[1], dtype=torch.float32,
                        device=dev),
        torch.arange(0, H * W, 3, dtype=torch.int32, device=dev), H, W,
        scene.intrinsics_lidar, scene.intrinsics_hoz_lidar)
    t = torch.tensor(float(scene.times[1]), device=dev)
    kw = dict(num_steps_occ=32, cal_lidar_color=True, occ_thresh=0.01,
              slab=8)
    args = (ro, rd, t, tr.occ, tr.occ_grid_lidar)

    def both(trans_eps=1e-4):
        rend.slab_counter(dev).zero_()
        got = rend.run_occupancy_stream(*args, trans_eps=trans_eps, **kw)
        n_got = int(rend.slabs_run)
        rend.slabs_run.zero_()
        ref = rend.stream_batch(*args, bg_color=None, skip_warp=False,
                                     trans_eps=trans_eps, **kw)
        assert n_got == int(rend.slabs_run), (n_got, int(rend.slabs_run))
        _close_to_max(got, ref)
        return got, n_got

    first, n = both()
    assert 0 < n <= 4, n
    # every ray dead before the first slab: the device skips all four
    dead, n_dead = both(trans_eps=2.0)
    assert n_dead == 0 and float(dead["weights_sum_lidar"].abs().max()) == 0
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rend.run_occupancy_stream(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    with torch.no_grad():
        tr.occ_grid_lidar[:, :, 12:] = 0.0
    second, _ = both()
    assert not torch.equal(first["depth_lidar"], second["depth_lidar"])
    assert len(rend.frame_graphs.graphs) == 2


def test_load_drops_the_frame_graphs(dev, tmp_path):
    """A load installs new grids, so it drops both renderers' frame graphs
    (and their pools); the next frame captures anew and renders what the
    saved state rendered."""
    tr = _render_trainer()
    tr.cfg.workspace = tr.workspace = str(tmp_path)
    before = tr.render_lidar_frame(1)
    ema = tr.render_lidar_frame(1, use_ema=True)
    assert tr.renderer._frame_graphs is not None
    assert tr.ema_renderer._frame_graphs is not None
    tr.save_checkpoint(full=True)
    assert tr.load_checkpoint("latest")
    assert tr.renderer._frame_graphs is None
    assert tr.ema_renderer._frame_graphs is None
    after = tr.render_lidar_frame(1)
    for k in before:
        np.testing.assert_allclose(after[k], before[k], rtol=0, err_msg=k,
                                   atol=1e-6 * np.abs(before[k]).max())
    assert not np.array_equal(ema["depth"], before["depth"])


# ----------------------------------------------------------------------
# the refresh, the refine step and the mesh export's density query, each
# captured as a CUDA graph (train/graphs.py), against their eager versions
# ----------------------------------------------------------------------

def test_graphed_refresh_matches_eager_refresh(dev):
    """Four refreshes of the toy trainer's grids from four seeds, graphed
    (an eager warm-up, then the capture and replays) against the eager
    refresh from the same seed and grids: the grids within 1e-6 of their
    max, the same launches counted (a replay counts its capture's)."""
    g, _ = _graph_pair()
    grids = g._occ_grids()
    for seed in range(4):
        saved = [x.clone() for x in grids]
        kernels.reset_launch_counts()
        g.refresh_occupancy(seed)
        graphed = dict(kernels.LAUNCHES)
        got = [x.clone() for x in grids]
        for x, s in zip(grids, saved):
            x.copy_(s)
        kernels.reset_launch_counts()
        g.refresh_occupancy(seed, graphed=False)
        assert kernels.LAUNCHES == graphed and graphed["multihot_fwd"] > 0
        for a, b, s in zip(got, grids, saved):
            assert not torch.equal(b, s)
            assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())
    prog, = g.programs.values()
    assert (prog.warm, prog.replays) == (1, 3)


@torch.no_grad()
def _sync_refine(src, dst):
    for p, q in zip(src.unet.parameters(), dst.unet.parameters()):
        q.copy_(p)
        for k, v in src.opt.state.get(p, {}).items():
            dst.opt.state[q][k].copy_(v)
    for a, b in zip(src.unet.buffers(), dst.unet.buffers()):
        b.copy_(a)
    dst.generator.set_state(src.generator.get_state())


def test_graphed_refine_steps_match_eager_steps(dev):
    """Six f32 refine steps of a small U-Net, graphed (two eager warm-ups,
    the capture, replays) against eager steps of a copy given the graphed
    one's state and generator state before each step: loss, gradients and
    BatchNorm statistics within 1e-5 of each tensor's max (cuDNN's and
    the bilinear upsampling's backward may sum in another order), and the
    parameters and Adam moments within 1e-5 after the eager Adam step is
    taken again on the replay's gradients (Adam's m / (sqrt(v) + 1e-8)
    turns a summation-order difference in a gradient near 1e-8 into one
    the size of the rate); injected draws raise on the graphed path."""
    import copy
    from nvsf_torch.models.unet import UNet
    from nvsf_torch.train.refine import RefineSteps
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = torch.Generator().manual_seed(0)
        x = torch.rand((2, 3, 32, 64), generator=cpu).to(dev)
        gt = (torch.rand((2, 1, 32, 64), generator=cpu) > 0.4).float().to(dev)
        unet = UNet(3, 8, 1, generator=cpu).to(dev).train()
        g = RefineSteps(unet, x, gt, steps=100, lr=1e-3)
        e = RefineSteps(copy.deepcopy(unet), x, gt, steps=100, lr=1e-3,
                        graphed=False)
        for i in range(6):
            _sync_refine(g, e)
            snap = [(q.detach().clone(), {k: v.clone() for k, v in
                                          e.opt.state.get(q, {}).items()})
                    for q in e.unet.parameters()]
            lg, le = float(g.step(i)), float(e.step(i))
            assert abs(lg - le) <= 1e-5 * abs(le), (i, lg, le)
            pairs = list(zip(g.unet.parameters(), e.unet.parameters()))
            for p, q in pairs:
                _close(p.grad, q.grad, q.grad)
            for a, b in zip(g.unet.buffers(), e.unet.buffers()):
                _close(a, b, b)
            with torch.no_grad():
                for (p, q), (q0, st0) in zip(pairs, snap):
                    q.copy_(q0)
                    q.grad.copy_(p.grad)
                    for k, v in e.opt.state[q].items():
                        v.copy_(st0[k]) if k in st0 else v.zero_()
                e.opt.step()
            for p, q in pairs:
                _close(p.detach(), q.detach(), q.detach())
                for k, v in g.opt.state[p].items():
                    _close(v, e.opt.state[q][k], e.opt.state[q][k])
        assert (g.program.warm, g.program.replays) == (2, 4)
        assert float(g.lr) == pytest.approx(g.sched(5))
        with pytest.raises(ValueError, match="injected draws"):
            g.step(6, draws={})
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def test_graphed_density_query_matches_eager(dev):
    """The mesh export's density query of a 40 x 30 x 20 grid in chunks of
    4096 (the last padded), graphed (the first chunk its eager warm-up)
    against eager: sigma within 1e-6 of its max, the same launches
    counted."""
    from nvsf_torch.render.export import extract_density_grid
    tr = _render_trainer()
    kw = dict(bound_min=(-0.5, -0.5, -0.2), bound_max=(0.5, 0.5, 0.2),
              xyz_res=(40, 30, 20), chunk=4096)
    kernels.reset_launch_counts()
    got = extract_density_grid(tr, **kw)
    graphed = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    ref = extract_density_grid(tr, graphed=False, **kw)
    assert kernels.LAUNCHES == graphed and graphed["multihot_fwd"] > 0
    assert got.shape == (40, 30, 20) and np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()
    prog = tr.programs[("density query", 4096, True)]
    assert (prog.warm, prog.replays) == (1, 5)


def test_load_drops_the_refresh_and_query_graphs(dev, tmp_path):
    """A load replaces the grids and parameters these graphs read, so it
    drops them; the next refresh warms up and captures anew. A replay
    refuses a grid replaced since its capture, and a parameter whose
    storage was."""
    from nvsf_torch.render.export import extract_density_grid
    g, _ = _graph_pair()
    g.cfg.workspace = g.workspace = str(tmp_path)
    for seed in (1, 2):
        g.refresh_occupancy(seed)
        extract_density_grid(g, (-0.5,) * 3, (0.5,) * 3, (8, 8, 8),
                             chunk=256)
    assert len(g.programs) == 2
    g.save_checkpoint(full=True)
    assert g.load_checkpoint("latest")
    assert g.programs == {}
    for seed in (3, 4):
        g.refresh_occupancy(seed)
    prog, = g.programs.values()
    assert (prog.warm, prog.replays) == (1, 1)
    grid = g.occ_grid_lidar
    g.occ_grid_lidar = grid.clone()
    with pytest.raises(RuntimeError, match="occ_grid_lidar"):
        g.refresh_occupancy(5)
    g.occ_grid_lidar = grid
    p = next(g.field.parameters())
    p.data = p.data.clone()
    with pytest.raises(RuntimeError, match="replaced"):
        g.refresh_occupancy(5)
