"""Plain float32 reference of NVSF's field, renderer and training losses.

Written from the model's equations for this benchmark: PyTorch tensor
operations only, no hand-written kernel, no CUDA graph, no import of the
program under test. The hash grids are instant-ngp multiresolution hash
encodings evaluated corner by corner; the K-planes are bilinear
``grid_sample`` lookups (align_corners, border); the MLPs are bias-free
ReLU stacks; compositing is the alpha quadrature over the occupancy-
compacted or the dense uniform samples.

Parameters live in a flat dict whose names follow the program's
``named_parameters()`` (``planes_lidar.0.0``, ``hash_lidar.static``,
``flow.grid``, ``sigma_net.0`` ...), so that one set of initial weights,
made by ``init_params``, feeds both sides.

``mm`` is the matrix product every MLP layer runs: float32 with TF32 off
for the reference, a lower precision for the control (``fp8_mm``).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

PRIMES = (1, 2654435761, 805459861, 3674653429)
COO = tuple(itertools.combinations(range(4), 2))
STATIC = tuple(i for i, c in enumerate(COO) if 3 not in c)
DYNAMIC = tuple(i for i, c in enumerate(COO) if 3 in c)
DYN_AXES = ((0, 1), (0, 2), (1, 2))
DYN_KEYS = ("dyn_xyt", "dyn_xzt", "dyn_yzt")
NUM_BASIS = 4
FREQ_DIM = 3 * 12 * 2
SH_DIM = 16
SLOW = ("flow", "intensity_net", "raydrop_net")


def f32_mm(x, w):
    return x @ w


def _fp8(a, dtype=torch.float8_e4m3fn):
    """Per-tensor scaled float8 rounding (e4m3 by default, e5m2 for
    gradients)."""
    top = torch.finfo(dtype).max
    s = a.abs().amax().clamp_min(1e-30) / top
    return (a / s).to(dtype).to(torch.float32) * s


class _FP8MatMul(torch.autograd.Function):
    """x @ w as float8 training computes it: both operands of the forward
    rounded to scaled e4m3, the incoming gradient to scaled e5m2, each
    product of the backward taken from the rounded operands."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x), _fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ wq.t(), xq.t() @ gq


def fp8_mm(x, w):
    """The control's product: float8 in the forward and the backward."""
    return _FP8MatMul.apply(x, w)


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------

def level_res(base, top, levels):
    if levels == 1:
        return [int(base)]
    s = math.exp2(math.log2(top / base) / (levels - 1))
    return [int(math.floor(base * s ** l)) for l in range(levels)]


def plane_hw(c, si, ci):
    s = 2 ** si
    reso = [c["min_resolution"] * s] * 3 + [c["time_resolution"]]
    a, b = COO[ci]
    return reso[b], reso[a]


def mlp_dims(c):
    """name -> layer widths of every MLP."""
    Lh, Fh = c["n_levels_hash"], c["n_features_per_level_hash"]
    plane_dim = c["n_features_per_level_plane"] * c["n_levels_plane"] * 2
    sigma_in = plane_dim + Lh * Fh + 3 * Lh * Fh // NUM_BASIS
    geo = c["geo_feat_dim"]
    flow_in = c["flow_n_levels"] * c["flow_n_features_per_level"] // NUM_BASIS

    def dims(i, h, o, n):
        return [i] + [h] * (n - 1) + [o]
    return {
        "flow.mlp": dims(flow_in, c["hidden_dim_flow"], 6,
                         c["num_layers_flow"]),
        "sigma_net": dims(sigma_in, c["hidden_dim_sigma"], 1 + geo,
                          c["num_layers_sigma"]),
        "intensity_net": dims(FREQ_DIM + geo, c["hidden_dim_lidar"], 1,
                              c["num_layers_color"]),
        "raydrop_net": dims(FREQ_DIM + geo, c["hidden_dim_lidar"], 1,
                            c["num_layers_color"]),
        "color_net": dims(SH_DIM + geo, c["hidden_dim_color"], 3,
                          c["num_layers_color"]),
    }


def param_shapes(c) -> Dict[str, tuple]:
    """Every parameter of the field by name, in the program's order."""
    out = {}
    Fh, Lh = c["n_features_per_level_hash"], c["n_levels_hash"]
    Fp = c["n_features_per_level_plane"]
    for br in ("lidar", "camera"):
        for si in range(c["n_levels_plane"]):
            for ci in range(len(COO)):
                H, W = plane_hw(c, si, ci)
                out[f"planes_{br}.{si}.{ci}"] = (Fp, H * W)
        out[f"hash_{br}.static"] = (Fh, Lh << c["log2_hashmap_size"])
        for k, hs in zip(DYN_KEYS, c["hash_size_dynamic"]):
            out[f"hash_{br}.{k}"] = (c["time_resolution"], Fh, Lh << hs)
        if br == "lidar":
            lidar = dict(out)
            out.clear()
    order = {**lidar}
    order.update(out)
    order["flow.grid"] = (c["flow_n_features_per_level"],
                          c["flow_n_levels"] << c["flow_log2_hashmap_size"])
    for name, d in mlp_dims(c).items():
        for i in range(len(d) - 1):
            order[f"{name}.{i}"] = (d[i], d[i + 1])
    # the program's module order: planes_lidar, hash_lidar, planes_camera,
    # hash_camera, flow, sigma_net, intensity_net, raydrop_net, color_net
    keys = [k for k in order if k.startswith("planes_lidar")] \
        + [k for k in order if k.startswith("hash_lidar")] \
        + [k for k in order if k.startswith("planes_camera")] \
        + [k for k in order if k.startswith("hash_camera")] \
        + [k for k in order if k.startswith("flow.")] \
        + [k for k in order if k.startswith("sigma_net")] \
        + [k for k in order if k.startswith("intensity_net")] \
        + [k for k in order if k.startswith("raydrop_net")] \
        + [k for k in order if k.startswith("color_net")]
    return {k: order[k] for k in keys}


@torch.no_grad()
def init_params(c, seed: int, device) -> Dict[str, torch.Tensor]:
    """The initial weights from ``seed``, drawn on ``device`` one tensor a
    call: spatial planes U(0.1, 0.5), time planes ones, hash tables
    U(-1e-4, 1e-4), MLPs He-uniform, the flow MLP's last layer N(0, 1e-3)."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    flow_last = f"flow.mlp.{c['num_layers_flow'] - 1}"
    for name, shape in param_shapes(c).items():
        if name.startswith("planes_"):
            if int(name.rsplit(".", 1)[1]) in DYNAMIC:
                p = torch.ones(shape, device=device)
            else:
                p = torch.rand(shape, generator=g, device=device) * 0.4 + 0.1
        elif name.startswith("hash_") or name == "flow.grid":
            p = (torch.rand(shape, generator=g, device=device) * 2 - 1) * 1e-4
        elif name == flow_last:
            p = 1e-3 * torch.randn(shape, generator=g, device=device)
        else:
            bound = (6.0 / shape[0]) ** 0.5
            p = (torch.rand(shape, generator=g, device=device) * 2 - 1) * bound
        out[name] = p
    return out


# ----------------------------------------------------------------------
# encoders
# ----------------------------------------------------------------------

def hash_encode(table, x, resolutions, T):
    """Multiresolution hash encoding. table [F, L*T] (level l's slots at
    columns l*T ...); x [N, D] in [0, 1] -> [N, L*F], level-major. A level
    whose (r+1)^D corners fit in T slots is indexed densely."""
    N, D = x.shape
    dev = x.device
    out = []
    for li, r in enumerate(resolutions):
        pos = x * float(r)
        c0 = torch.floor(pos)
        w = pos - c0
        c0 = c0.long()
        dense = (r + 1) ** D <= T
        acc = None
        for corner in itertools.product((0, 1), repeat=D):
            c = torch.clamp(c0 + torch.tensor(corner, device=dev), 0, r)
            if dense:
                idx = c[:, 0]
                stride = 1
                for d in range(1, D):
                    stride *= r + 1
                    idx = idx + c[:, d] * stride
            else:
                h = (c[:, 0] * PRIMES[0]) & 0xFFFFFFFF
                for d in range(1, D):
                    h = h ^ ((c[:, d] * PRIMES[d]) & 0xFFFFFFFF)
                idx = h & (T - 1)
            wt = None
            for d in range(D):
                wd = w[:, d] if corner[d] else 1.0 - w[:, d]
                wt = wd if wt is None else wt * wd
            term = table[:, li * T + idx] * wt[None]
            acc = term if acc is None else acc + term
        out.append(acc.t())
    return torch.cat(out, dim=-1)


def lagrange_fold(table, t):
    """[B*F', C] rows in NUM_BASIS blocks -> sum_j basis_j(t) block_j."""
    nodes = [i / (NUM_BASIS - 1) for i in range(NUM_BASIS)]
    blocks = table.reshape(NUM_BASIS, table.shape[0] // NUM_BASIS, -1)
    out = 0.0
    for j in range(NUM_BASIS):
        b = torch.ones((), device=table.device)
        for m in range(NUM_BASIS):
            if m != j:
                b = b * (t - nodes[m]) / (nodes[j] - nodes[m])
        out = out + b * blocks[j]
    return out


def time_bins(tables, t):
    """[TR, F, C] time-binned tables lerped at t (bins read clamped, the
    weight from the unclamped bin)."""
    TR = tables.shape[0]
    idx = t * (TR - 1)
    i1 = torch.floor(idx)
    w2 = idx - i1
    i1 = i1.long()
    i2 = torch.clamp(i1 + 1, max=TR - 1)
    a = tables.index_select(0, i1.clamp(0, TR - 1).reshape(1))[0]
    b = tables.index_select(0, i2.clamp(0, TR - 1).reshape(1))[0]
    return (1.0 - w2) * a + w2 * b


def plane_lookup(plane, H, W, u, v):
    """Bilinear lookup of a [F, H*W] plane at (u -> W, v -> H) in [0, 1],
    align_corners, border -> [N, F]."""
    img = plane.reshape(1, plane.shape[0], H, W)
    grid = torch.stack([u * 2 - 1, v * 2 - 1], dim=-1).reshape(1, 1, -1, 2)
    out = F.grid_sample(img, grid, mode="bilinear", padding_mode="border",
                        align_corners=True)
    return out[0, :, 0].t()


def planes_static(P, c, br, xt):
    feats = []
    for si in range(c["n_levels_plane"]):
        f = None
        for ci in STATIC:
            a, b = COO[ci]
            H, W = plane_hw(c, si, ci)
            g = plane_lookup(P[f"planes_{br}.{si}.{ci}"], H, W, xt[:, a],
                             xt[:, b])
            f = g if f is None else f * g
        feats.append(f)
    return torch.cat(feats, dim=-1)


def planes_dynamic(P, c, br, x, t):
    feats = []
    tt = t.expand(x.shape[0])
    for si in range(c["n_levels_plane"]):
        f = None
        for ci in DYNAMIC:
            a, _ = COO[ci]
            H, W = plane_hw(c, si, ci)
            g = plane_lookup(P[f"planes_{br}.{si}.{ci}"], H, W, x[:, a], tt)
            f = g if f is None else f * g
        feats.append(f)
    return torch.cat(feats, dim=-1)


def hash_static(P, c, br, x):
    return hash_encode(P[f"hash_{br}.static"], x,
                       level_res(c["base_resolution"], c["max_resolution"],
                                 c["n_levels_hash"]),
                       1 << c["log2_hashmap_size"])


def hash_dynamic(P, c, br, x, t):
    res = level_res(c["base_resolution"], c["max_resolution"],
                    c["n_levels_hash"])
    outs = []
    for k, (a, b), hs in zip(DYN_KEYS, DYN_AXES, c["hash_size_dynamic"]):
        tbl = lagrange_fold(time_bins(P[f"hash_{br}.{k}"], t), t)
        outs.append(hash_encode(tbl, torch.stack([x[:, a], x[:, b]], -1),
                                res, 1 << hs))
    return torch.cat(outs, dim=-1)


def mlp(P, name, x, mm):
    n = sum(1 for k in P if k.startswith(name + ".")
            and k[len(name) + 1:].isdigit())
    h = x
    for i in range(n):
        h = mm(h, P[f"{name}.{i}"])
        if i != n - 1:
            h = torch.relu(h)
    return h


def flow(P, c, xn, t, mm):
    tbl = lagrange_fold(P["flow.grid"], t)
    h = hash_encode(tbl, xn, level_res(c["flow_base_resolution"],
                                       c["flow_max_resolution"],
                                       c["flow_n_levels"]),
                    1 << c["flow_log2_hashmap_size"])
    return mlp(P, "flow.mlp", h, mm)


class _TruncExp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def density(P, c, x, t, lidar, mm, warp=True):
    """x [N, 3] in [-bound, bound], t a 0-d tensor -> (sigma [N],
    geo_feat [N, G]). With ``warp`` the dynamic features blend the query
    with its flow-warped neighbours at the next and previous frame
    (0.5 / 0.25 / 0.25; a missing neighbour takes the query's own); the
    warped hash lookups carry no gradient."""
    br = "lidar" if lidar else "camera"
    b, nf = c["bound"], c["num_frames"]
    xn = (x + b) / (2 * b)
    N = xn.shape[0]
    xt = torch.cat([xn, t.expand(N, 1)], dim=-1)
    hs = hash_static(P, c, br, xn)
    ps = planes_static(P, c, br, xt)
    hd = hash_dynamic(P, c, br, xn, t)
    pd = planes_dynamic(P, c, br, xn, t)
    if warp:
        fl = flow(P, c, xn, t, mm)
        fi = torch.floor(t * (nf - 1))
        t1, t2 = (fi + 1) / nf, (fi - 1) / nf
        x1, x2 = xn + fl[:, :3], xn + fl[:, 3:]
        with torch.no_grad():
            h1 = hash_dynamic(P, c, br, x1.detach(), t1)
            h2 = hash_dynamic(P, c, br, x2.detach(), t2)
        p1 = planes_dynamic(P, c, br, x1, t1)
        p2 = planes_dynamic(P, c, br, x2, t2)
        nxt, prv = fi < nf - 1, fi > 0
        h1, p1 = torch.where(nxt, h1, hd), torch.where(nxt, p1, pd)
        h2, p2 = torch.where(prv, h2, hd), torch.where(prv, p2, pd)
        pd = 0.5 * pd + 0.25 * (p1 + p2)
        hd = 0.5 * hd + 0.25 * (h1 + h2)
    h = mlp(P, "sigma_net", torch.cat([ps, pd, hs, hd], dim=-1), mm)
    return _TruncExp.apply(h[:, 0]), h[:, 1:]


def frequency_encode(x, degree=12):
    freqs = (2.0 ** torch.arange(degree, dtype=torch.float32,
                                 device=x.device)) * math.pi
    ang = x[..., :, None] * freqs
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *x.shape[:-1], x.shape[-1] * degree * 2)


def sh_encode(u):
    d = u * 2.0 - 1.0
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, xz, yz = x * y, x * z, y * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        0.28209479177387814 * torch.ones_like(x),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x, 1.0925484305920792 * xy,
        -1.0925484305920792 * yz, 0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], dim=-1)


def color(P, d, geo, lidar, mask, mm):
    """View dirs d [N, 3] -> LiDAR (raydrop, intensity) or camera rgb,
    after a sigmoid, zero where ``mask`` is false."""
    dn = (d + 1.0) / 2.0
    if lidar:
        inp = torch.cat([frequency_encode(dn), geo], dim=-1)
        h = torch.cat([mlp(P, "raydrop_net", inp, mm),
                       mlp(P, "intensity_net", inp, mm)], dim=-1)
    else:
        h = mlp(P, "color_net", torch.cat([sh_encode(dn), geo], -1), mm)
    return torch.where(mask[:, None], torch.sigmoid(h), 0.0)


# ----------------------------------------------------------------------
# rays, samples, compositing
# ----------------------------------------------------------------------

def lidar_dirs(inds, H, W, K, Kh):
    j = (inds // W).to(torch.float32)
    i = (inds % W).to(torch.float32)
    beta = -(i - W / 2) / W * float(Kh[1]) / 180 * math.pi
    alpha = (float(K[0]) - j / H * float(K[1])) / 180 * math.pi
    return torch.stack([torch.cos(alpha) * torch.cos(beta),
                        torch.cos(alpha) * torch.sin(beta),
                        torch.sin(alpha)], dim=-1)


def camera_dirs(inds, H, W, K):
    j = (inds // W).to(torch.float32) + 0.5
    i = (inds % W).to(torch.float32) + 0.5
    d = torch.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                     torch.ones_like(i)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def to_world(pose, dirs):
    rd = dirs @ pose[:3, :3].T
    return pose[:3, 3].expand_as(rd), rd


def linspace01(T, device):
    z = torch.arange(T, dtype=torch.float32, device=device) \
        * torch.tensor(1.0 / (T - 1), dtype=torch.float32, device=device)
    z[-1] = 1.0
    return z


def near_far(c, ro, rd, lidar):
    N = ro.shape[0]
    if lidar:
        return (torch.full((N, 1), c["min_near_lidar"] * c["scale"],
                           device=ro.device),
                torch.full((N, 1), c["lidar_max_depth"] * c["scale"],
                           device=ro.device))
    b = float(c["bound"])
    safe = torch.where(rd.abs() < 1e-15, torch.where(rd >= 0, 1e-15, -1e-15),
                       rd)
    t0 = (-b - ro) / safe
    t1 = (b - ro) / safe
    tmin = torch.minimum(t0, t1).amax(-1)
    tmax = torch.maximum(t0, t1).amin(-1)
    nears = torch.clamp(tmin, min=c["min_near"] * c["scale"])
    return nears[:, None], torch.maximum(tmax, nears)[:, None]


def occupied(c, grid, xyz):
    G, b = c["occ_grid_size"], c["bound"]
    u = (xyz / b + 1.0) * 0.5
    ijk = torch.clamp((u * G).to(torch.int64), 0, G - 1)
    flat = (ijk[..., 0] * G + ijk[..., 1]) * G + ijk[..., 2]
    return grid.reshape(-1)[flat] > c["occ_thresh"]


def compact(c, grid, ro, rd, z, K):
    """Of T candidate depths per ray, the occupied ones in z order; K of
    them evenly strided where more are occupied, else all and the rest
    invalid (set to the last candidate)."""
    occ = occupied(c, grid, ro[:, None] + rd[:, None] * z[..., None])
    m = occ.sum(-1, keepdim=True)
    packed = torch.gather(z, 1, torch.argsort((~occ).int(), dim=-1,
                                              stable=True))
    k = torch.arange(K, device=z.device)[None]
    strided = ((k.to(torch.float32) + 0.5) * m.to(torch.float32)
               / K).to(torch.int64)
    ranks = torch.where(m > K, strided, torch.minimum(k, (m - 1).clamp_min(0)))
    valid = k < m.clamp(max=K)
    return torch.where(valid, torch.gather(packed, 1, ranks), z[:, -1:]), \
        valid


def segment_jitter(z, sd, T, K, u):
    N = z.shape[0]
    gap_r = torch.cat([z[:, 1:] - z[:, :-1], sd.expand(N, 1)], dim=-1)
    gap_l = torch.cat([sd.expand(N, 1), gap_r[:, :-1]], dim=-1)
    cap = sd * (T / K)
    wl = torch.minimum(0.5 * gap_l, cap)
    wr = torch.minimum(0.5 * gap_r, cap)
    return z - wl + u * (wl + wr)


def composite(P, c, rd, z, deltas, sigma, geo, lidar, mm, valid=None):
    N, S = z.shape
    sigma = sigma.reshape(N, S)
    if valid is not None:
        sigma = torch.where(valid, sigma, 0.0)
    ex = 2.0 if c["active_sensor"] else 1.0
    alpha = 1.0 - torch.exp(-ex * deltas * c["density_scale"] * sigma)
    trans = torch.cumprod(torch.cat([torch.ones((N, 1), device=z.device),
                                     1.0 - alpha + 1e-15], -1), -1)[:, :-1]
    w = alpha * trans
    mask = w > 1e-4
    if valid is not None:
        mask = mask & valid
    rgb = color(P, rd[:, None].expand(N, S, 3).reshape(-1, 3), geo, lidar,
                mask.reshape(-1), mm).reshape(N, S, -1)
    wsum = w.sum(-1)
    depth = (w * z).sum(-1)
    image = (w[..., None] * rgb).sum(-2)
    if not lidar:
        image = image + (1.0 - wsum)[:, None]
    return depth, image, wsum


def query(P, c, pts, t, lidar, mm, chunks=1, warp=True):
    """density over [M, 3] points, in ``chunks`` recomputed in the
    backward when gradients are on."""
    def fn(p):
        return density(P, c, p, t, lidar, mm, warp)
    if chunks <= 1:
        return fn(pts)
    from torch.utils.checkpoint import checkpoint
    outs = [checkpoint(fn, p, use_reentrant=False) if torch.is_grad_enabled()
            else fn(p) for p in pts.tensor_split(chunks)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def render_rays(P, c, ro, rd, t, lidar, mm, grid=None, K=None,
                z_noise=None, jitter_u=None, chunks=1):
    """A batch of rays through the dense uniform sampler (no grid) or the
    occupancy-compacted one (with ``grid`` and ``K``); with ``z_noise``
    [N, T] the candidates are perturbed, with ``jitter_u`` [N, K] the
    compacted samples spread over their segments."""
    T = c["num_steps"]
    b = float(c["bound"])
    nears, fars = near_far(c, ro, rd, lidar)
    z = nears + (fars - nears) * linspace01(T, ro.device)[None]
    sd = (fars - nears) / T
    if z_noise is not None:
        z = z + (z_noise - 0.5) * sd
    valid = None
    if grid is not None:
        z, valid = compact(c, grid, ro, rd, z, K)
        if jitter_u is not None:
            z = segment_jitter(z, sd, T, K, jitter_u)
    xyz = torch.clamp(ro[:, None] + rd[:, None] * z[..., None], -b, b)
    sigma, geo = query(P, c, xyz.reshape(-1, 3), t, lidar, mm, chunks)
    deltas = torch.cat([z[:, 1:] - z[:, :-1], sd.expand(z.shape[0], 1)], -1)
    if grid is not None:
        cap = sd * (c["occ_delta_clamp"] if c["occ_delta_clamp"] > 0
                    else 2.0 * (T / K))
        deltas = torch.minimum(deltas.clamp_min(0.0), cap)
    return composite(P, c, rd, z, deltas, sigma, geo, lidar, mm, valid) \
        + (z,)


# ----------------------------------------------------------------------
# losses
# ----------------------------------------------------------------------

def min_dist2(a, b, b_mask=None, block=4096):
    """For each point of a, the squared distance to its nearest valid
    point of b (1e10 where b has none); differentiable through the
    nearest pair."""
    with torch.no_grad():
        best = torch.full((a.shape[0],), 1e10, device=a.device)
        arg = torch.zeros((a.shape[0],), dtype=torch.int64, device=a.device)
        for j in range(0, b.shape[0], block):
            bb = b[j:j + block]
            d2 = torch.cdist(a, bb, compute_mode="donot_use_mm_for_euclid_dist"
                             ) ** 2
            if b_mask is not None:
                d2 = torch.where(b_mask[None, j:j + block], d2, 1e10)
            v, i = d2.min(-1)
            take = v < best
            best = torch.where(take, v, best)
            arg = torch.where(take, i + j, arg)
    d = ((a - b[arg]) ** 2).sum(-1)
    return torch.where(best >= 1e10, 1e10, d)


def chamfer(a, b, a_mask=None, b_mask=None):
    d1, d2 = min_dist2(a, b, b_mask), min_dist2(b, a, a_mask)
    if a_mask is not None:
        d1 = torch.where(a_mask, d1, 0.0)
    if b_mask is not None:
        d2 = torch.where(b_mask, d2, 0.0)
    return d1, d2


def flow_term(pc, pcm, nxt, nxtm, fl):
    d1, d2 = chamfer(pc + fl, nxt, pcm, nxtm)
    mag = torch.where(pcm[:, None], fl.abs(), 0.0).sum() \
        / (torch.clamp(pcm.sum(), min=1) * 3)
    return 0.5 * (d1.sum() + d2.sum()) + mag


CRIT: Dict[str, Callable] = {"mse": lambda p, g: (p - g) ** 2,
                             "l1": lambda p, g: (p - g).abs()}
