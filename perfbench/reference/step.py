"""The reference's training steps and LiDAR frame render, built on
``model.py``.

``train_steps`` runs the joint LiDAR + camera step over the given (frame,
patch) steps, drawing its random numbers from a generator seeded as the
program seeds its own, in the order the step takes them (``step_draws``):
the first step from the initial weights, each later step it is asked for
from the state the program held before it (after one Adam step two
precisions part by Adam's normalisation of near-zero gradients, so no
float32 trajectory of its own can follow the program's later steps); the
steps in between only draw. It returns each computed step's loss and loss
terms, error maps, gradient norm, parameter change and EMA change.

``render_lidar_frame`` renders a whole LiDAR pano from given parameters and
occupancy grid without early exit: every compacted sample of every ray is
composited.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from perfbench.reference import model as M


# ----------------------------------------------------------------------
# the flow loss's point clouds, worked out from the panos
# ----------------------------------------------------------------------

def pano_points(depth, K, Kh):
    H, W = depth.shape
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    beta = -(i - W / 2) / W * float(Kh[1]) / 180 * np.pi
    alpha = (float(K[0]) - j / H * float(K[1])) / 180 * np.pi
    dirs = np.stack([np.cos(alpha) * np.cos(beta),
                     np.cos(alpha) * np.sin(beta), np.sin(alpha)], axis=-1)
    pts = dirs * depth[..., None]
    return pts[np.where(depth != 0.0)]


def remove_ground(pc, dist_min, dist_max, z_limit, iters=100, seed=0):
    """Range and height filter, RANSAC ground plane (0.15 m, ``iters``
    draws of a numpy generator seeded with ``seed``), statistical outlier
    removal (20 neighbours, 2 std)."""
    d = np.linalg.norm(pc[:, :2], axis=1)
    pc = pc[(d > dist_min) & (d < dist_max)]
    pc = pc[(pc[:, 2] > z_limit[0]) & (pc[:, 2] < z_limit[1])]
    if len(pc) < 10:
        return pc
    rng = np.random.default_rng(seed)
    best, best_n = np.zeros(len(pc), bool), -1
    for _ in range(iters):
        p0, p1, p2 = pc[rng.choice(len(pc), 3, replace=False)]
        n = np.cross(p1 - p0, p2 - p0)
        norm = np.linalg.norm(n)
        if norm < 1e-9:
            continue
        n = n / norm
        mask = np.abs(pc @ n - np.dot(n, p0)) < 0.15
        if int(mask.sum()) > best_n:
            best_n, best = int(mask.sum()), mask
    pts = pc[~best]
    if len(pts) <= 20:
        return pts
    dist, _ = cKDTree(pts).query(pts, k=21)
    mean_d = dist[:, 1:].mean(axis=1)
    return pts[mean_d < mean_d.mean() + 2.0 * mean_d.std()]


def frame_cloud(c, scene, i):
    """Frame i's non-ground points in scaled world coordinates."""
    pano = scene["panos"][i]
    depth = pano[:, :, 2] * pano[:, :, 0] / c["scale"]
    pts = pano_points(depth, scene["intrinsics_lidar"],
                      scene["intrinsics_hoz_lidar"])
    pts = remove_ground(pts, 1.0, 0.75 * c["lidar_max_depth"], (-2.5, 4.0))
    pw = pts * c["scale"]
    pose = scene["poses_lidar"][i]
    pw = (pose @ np.hstack([pw, np.ones((len(pw), 1), np.float32)]).T).T
    return pw[:, :3].astype(np.float32)


# ----------------------------------------------------------------------
# training steps
# ----------------------------------------------------------------------

def sample_pixels(H, W, N, gen, dev, emap=None, patch_hw=(1, 1)):
    """A step's pixel ids [N]. A random step draws them uniformly. A patch
    step draws N / (ph * pw) cells of the frame's coarse error map in
    proportion to its values (Gumbel top-k without replacement where they
    fit, else inverse-CDF draws with replacement), a uniform offset inside
    each cell, and a ph x pw patch at each, patch-major."""
    if emap is None:
        return torch.randint(0, H * W, (N,), generator=gen, device=dev)
    ph, pw = patch_hw
    He, We = emap.shape
    n = N // (ph * pw)
    logw = torch.log(torch.clamp(emap.reshape(-1), min=1e-12))
    if n > logw.numel():
        cdf = torch.cumsum(torch.softmax(logw, dim=0), dim=0)
        u = torch.rand((n,), generator=gen, device=dev) * cdf[-1]
        cells = torch.searchsorted(cdf, u, right=True).clamp_max(
            logw.numel() - 1)
    else:
        u = torch.rand((logw.numel(),), generator=gen, device=dev)
        g = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
        cells = torch.topk(logw + g, n).indices
    ux = torch.rand((n,), generator=gen, device=dev)
    uy = torch.rand((n,), generator=gen, device=dev)
    sx, sy = W / We, H / He
    x = torch.clamp(((cells % We).to(torch.float32) * sx + ux * sx)
                    .to(torch.int64), 0, W - pw)
    y = torch.clamp(((cells // We).to(torch.float32) * sy + uy * sy)
                    .to(torch.int64), 0, H - ph)
    oy, ox = torch.meshgrid(torch.arange(ph, device=dev),
                            torch.arange(pw, device=dev), indexing="ij")
    return ((y[:, None] + oy.reshape(1, -1)) * W
            + x[:, None] + ox.reshape(1, -1)).reshape(-1)


def diff_last(a, dim):
    """a[i] - a[i + 1] along ``dim``, the last difference repeated."""
    n = a.shape[dim]
    d = a.narrow(dim, 0, n - 1) - a.narrow(dim, 1, n - 1)
    return torch.cat([d, d.narrow(dim, n - 2, 1)], dim=dim)


def grad_loss(c, depth, gt, inds, pano_depth, patch_hw):
    """The patch step's depth-gradient term: on [B, ph, pw] patches in
    meters, alpha_grad x the L1 gap between the rendered and the GT
    depth's x / y differences, where the GT ray returned and the GT
    pano's second difference along that axis is under 0.05 m."""
    sc = c["scale"]
    shape = (-1,) + tuple(patch_hw)
    d = pano_depth / sc
    gxx = diff_last(diff_last(d, -1).abs(), -1).reshape(-1)[inds]
    gyy = diff_last(diff_last(d, -2).abs(), -2).reshape(-1)[inds]
    drop = gt[:, 0].reshape(shape)
    mx = drop * (gxx.abs() < 0.05).to(torch.float32).reshape(shape)
    my = drop * (gyy.abs() < 0.05).to(torch.float32).reshape(shape)
    pred = (depth / sc).reshape(shape)
    true = (gt[:, 2] / sc).reshape(shape)
    gl = (diff_last(pred, -1) * mx - diff_last(true, -1) * mx).abs() \
        + (diff_last(pred, -2) * my - diff_last(true, -2) * my).abs()
    return c["alpha_grad"] * gl.sum()


def step_draws(c, scene, dev, gen, emaps=None):
    """A step's random draws, in the order the program takes them: the
    LiDAR pixels, the camera pixels (on a patch step, ``emaps`` given: the
    error-map cells and the offsets in them), then per branch the
    candidates' noise [N, T] and (occupancy mode) the compacted samples'
    jitter [N, K]. How many numbers a step draws does not depend on the
    maps' values."""
    Hl, Wl = scene["panos"].shape[1:3]
    H, W = scene["images"].shape[1:3]
    occ = c["render_mode"] == "occupancy"
    Kl = c["num_steps_occ"]
    Kc = c["num_steps_occ_rgb"] or Kl
    T = c["num_steps"]
    N, Nc = c["num_rays_lidar"], c["num_rays"]
    patch = emaps is not None
    patch_hw = tuple(c["change_patch_size_lidar"]) if patch else (1, 1)
    inds = sample_pixels(Hl, Wl, N, gen, dev,
                         emaps["lidar"] if patch else None, patch_hw)
    inds_c = sample_pixels(H, W, Nc, gen, dev,
                           emaps["rgb"] if patch else None)
    noise = {}
    for br, n, K in (("lidar", N, Kl), ("rgb", Nc, Kc)):
        zn = torch.rand((n, T), generator=gen, device=dev)
        ju = torch.rand((n, K), generator=gen, device=dev) \
            if occ and c["occ_jitter"] else None
        noise[br] = (zn, ju)
    return inds, inds_c, noise


def step_loss(P, c, scene, dev, fi, gen, mm, clouds, grids, emaps=None):
    """One step's loss on frame ``fi`` (every frame of the scene is a
    training frame, frame index = global frame). ``emaps`` (the frame's
    LiDAR and camera error maps) makes it a patch step."""
    S = scene
    nf = c["num_frames"]
    t = torch.tensor(float(S["times"][fi]), dtype=torch.float32, device=dev)
    Hl, Wl = S["panos"].shape[1:3]
    H, W = S["images"].shape[1:3]
    Kl = c["num_steps_occ"]
    Kc = c["num_steps_occ_rgb"] or Kl
    patch = emaps is not None
    patch_hw = tuple(c["change_patch_size_lidar"]) if patch else (1, 1)
    inds, inds_c, noise = step_draws(c, scene, dev, gen, emaps)

    pose_l = torch.as_tensor(S["poses_lidar"][fi], device=dev)
    ro, rd = M.to_world(pose_l, M.lidar_dirs(
        inds, Hl, Wl, S["intrinsics_lidar"], S["intrinsics_hoz_lidar"]))
    pano = torch.as_tensor(S["panos"][fi], device=dev)
    gt = pano.reshape(-1, 3)[inds]
    pose_c = torch.as_tensor(S["poses"][fi], device=dev)
    Kcam = torch.as_tensor(S["intrinsics"], dtype=torch.float32, device=dev)
    ro_c, rd_c = M.to_world(pose_c, M.camera_dirs(inds_c, H, W, Kcam))
    gt_rgb = torch.as_tensor(S["images"][fi], device=dev).reshape(-1, 3)[
        inds_c]

    chunks = c["remat_chunks"]
    depth, image, _, _ = M.render_rays(
        P, c, ro, rd, t, True, mm, grids.get("lidar"), Kl, *noise["lidar"],
        chunks=chunks)
    _, image_c, _, _ = M.render_rays(
        P, c, ro_c, rd_c, t, False, mm, grids.get("rgb"), Kc, *noise["rgb"],
        chunks=chunks)

    g_rd, g_int, g_d = gt[:, 0], gt[:, 1] * gt[:, 0], gt[:, 2] * gt[:, 0]
    p_rd = image[:, 0]
    p_int = image[:, 1] * g_rd
    p_d = depth * g_rd
    terms = {"loss_rd": c["alpha_r"] * M.CRIT[c["raydrop_loss"]](p_rd, g_rd),
             "loss_d": c["alpha_d"] * M.CRIT[c["depth_loss"]](p_d, g_d),
             "loss_i": c["alpha_i"] * M.CRIT[c["intensity_loss"]](p_int,
                                                                  g_int)}
    parts = {k: v.sum() for k, v in terms.items()}
    total = parts["loss_d"] + parts["loss_rd"] + parts["loss_i"]
    sc = c["scale"]
    d1, d2 = M.chamfer(rd * (p_d / sc)[:, None], rd * (g_d / sc)[:, None])
    parts["chamfer"] = 0.5 * (d1 + d2).mean()
    total = total + parts["chamfer"]
    if c["flow_loss"]:
        g = int(round(float(S["times"][fi]) * (nf - 1)))
        pc, pcm = clouds(g)
        xn = (pc + c["bound"]) / (2 * c["bound"])
        fl = M.flow(P, c, xn, t, mm)
        for other, col, ok in ((min(g + 1, nf - 1), slice(0, 3), g < nf - 1),
                               (max(g - 1, 0), slice(3, 6), g > 0)):
            oc, ocm = clouds(other)
            if ok:
                parts["flow"] = parts.get("flow", 0.0) + M.flow_term(
                    pc, pcm, oc, ocm, fl[:, col])
        total = total + parts.get("flow", 0.0)
    if patch and c["grad_loss"]:
        parts["loss_sr"] = grad_loss(c, depth, gt, inds, pano[..., 2],
                                     patch_hw)
        total = total + parts["loss_sr"]
    rgb_ray = c["alpha_rgb"] * M.CRIT[c["rgb_loss"]](image_c, gt_rgb)
    parts["rgb"] = rgb_ray.sum()
    total = total + parts["rgb"]
    total = torch.where(torch.isnan(total), 0.0, total)
    # each branch's per-ray loss, which the step writes into its error map
    per_ray = terms["loss_d"] + terms["loss_rd"] + terms["loss_i"]
    rays = {"lidar": (inds, per_ray.detach()),
            "rgb": (inds_c, rgb_ray.sum(-1).detach())}
    return torch.where(torch.isinf(total), 1e5, total), \
        {k: float(v.detach()) if torch.is_tensor(v) else float(v)
         for k, v in parts.items()}, rays


def error_map_update(emap, inds, err, H, W):
    """A frame's error map [H / down, W / down] after a step: the per-ray
    errors min-max normalised to [1, 1000], 0.1 x the old value + 0.9 x
    that at each ray's coarse cell; and how many of the step's rays hit
    each cell (where several do, which write lands is unspecified)."""
    He, We = emap.shape
    err = err.to(torch.float32)
    lo, hi = err.min(), err.max()
    err = (err - lo) / (hi - lo + torch.finfo(torch.float32).eps) \
        * (1e3 - 1.0) + 1.0
    ey = ((inds // W).to(torch.float32) * (He / H)).to(torch.int64)
    ex = ((inds % W).to(torch.float32) * (We / W)).to(torch.int64)
    flat = ey * We + ex
    out = emap.clone().reshape(-1)
    out[flat] = 0.1 * out[flat] + 0.9 * err
    hits = torch.bincount(flat, minlength=He * We)
    return out.reshape(He, We), hits.reshape(He, We)


def train_steps(c: dict, scene: dict, params: Dict[str, torch.Tensor],
                steps: List[Tuple[int, bool]], seed: int, device,
                mm=M.f32_mm, grids=None, states=None) -> dict:
    """The checked steps ``[(frame, patch), ...]``, each a call of its own:
    the first from ``params``; each step ``k`` of ``states`` from the
    state it holds (``params``, Adam's ``exp_avg`` / ``exp_avg_sq``, the
    ``ema`` and the frame's error ``maps`` before the step); the others
    only draw their numbers. A step is the loss, its gradient, Adam(0.9,
    0.99, eps 1e-15) with the flow and LiDAR-head parameters at 0.1x the
    rate and the rate decayed 0.1 ** (step / iters), then the EMA (ema =
    decay x ema + (1 - decay) x params). Returns, for each step computed,
    {"losses": {k: loss}, "parts": {k: {term: value}}, "grads": {k: {name:
    |g|}}, "change": {k: {name: |p after - p before|}}, "ema": {k: {name:
    |ema after - ema before|}}, "error_rows": {k: {sensor: (its frame's
    error map after the step, the step's rays a cell)}}}."""
    dev = torch.device(device)
    states = states or {}
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    if grids is None:
        grids = {}
        if c["render_mode"] == "occupancy":
            G = c["occ_grid_size"]
            grids = {b: torch.full((G, G, G), 32.0, device=dev)
                     for b in ("lidar", "rgb")}
    cache = {}
    nf = c["num_frames"]
    P_max = 1
    Hl, Wl = scene["panos"].shape[1:3]
    H, W = scene["images"].shape[1:3]
    sizes = {"lidar": (Hl, Wl, 2), "rgb": (H, W, 4)}

    def ones(br):
        h, w, down = sizes[br]
        return torch.ones((h // down, w // down), device=dev)

    def clouds(g):
        if g not in cache:
            fi = int(np.argmin(np.abs(scene["times"] * (nf - 1) - g)))
            cache[g] = frame_cloud(c, scene, fi)
        return cache[g]

    computed = [k for k in range(len(steps)) if k == 0 or k in states]
    # every cloud the steps read, padded to the longest of them (the
    # program pads all frames alike; the pad is masked out)
    if c["flow_loss"]:
        for k in computed:
            g = int(round(float(scene["times"][steps[k][0]]) * (nf - 1)))
            for o in (g - 1, g, g + 1):
                if 0 <= o < nf:
                    clouds(o)
        P_max = max(len(v) for v in cache.values())

    def padded(g):
        pts = clouds(g)
        out = torch.zeros((P_max, 3), device=dev)
        mask = torch.zeros((P_max,), dtype=torch.bool, device=dev)
        out[:len(pts)] = torch.as_tensor(pts, device=dev)
        mask[:len(pts)] = True
        return out, mask

    def on(d):
        return {k: v.to(dev, torch.float32) for k, v in d.items()}

    iters = max(int(c["epochs"]) * nf, 1)
    decay_ema = c["ema_decay"]
    out = {"losses": {}, "parts": {}, "grads": {}, "change": {}, "ema": {},
           "error_rows": {}}
    for s, (fi, patch) in enumerate(steps):
        if s not in computed:
            step_draws(c, scene, dev, gen,
                       {br: ones(br) for br in sizes} if patch else None)
            continue
        if s == 0:
            P0 = {k: v.detach().clone() for k, v in params.items()}
            m = {k: torch.zeros_like(v) for k, v in P0.items()}
            v = {k: torch.zeros_like(p) for k, p in P0.items()}
            ema = {k: p.clone() for k, p in P0.items()}
            maps = {br: ones(br) for br in sizes}
        else:
            st = states[s]
            P0, m, v, ema = (on(st[k]) for k in ("params", "exp_avg",
                                                 "exp_avg_sq", "ema"))
            maps = on(st["maps"])
        ema0 = {k: e.clone() for k, e in ema.items()}
        P = {k: p.clone().requires_grad_(True) for k, p in P0.items()}
        loss, step_parts, rays = step_loss(P, c, scene, dev, fi, gen, mm,
                                           padded, grids,
                                           maps if patch else None)
        loss.backward()
        out["losses"][s] = float(loss.detach())
        out["parts"][s] = step_parts
        rows = {}
        for br, (inds, err) in rays.items():
            h, w, _ = sizes[br]
            row, hits = error_map_update(maps[br], inds, err, h, w)
            rows[br] = (row.cpu().numpy(), hits.cpu().numpy())
        out["error_rows"][s] = rows
        decay = 0.1 ** min(s / iters, 1.0)
        grads = {}
        with torch.no_grad():
            for k, p in P.items():
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                g = torch.nan_to_num(g, nan=0.0, posinf=float("inf"),
                                     neginf=float("-inf"))
                grads[k] = float(torch.linalg.vector_norm(g))
                lr = c["lr"] * decay * (0.1 if k.split(".")[0] in M.SLOW
                                        else 1.0)
                m[k].mul_(0.9).add_(g, alpha=0.1)
                v[k].mul_(0.99).addcmul_(g, g, value=0.01)
                bc1, bc2 = 1 - 0.9 ** (s + 1), 1 - 0.99 ** (s + 1)
                p.sub_(lr / bc1 * m[k] / (v[k].sqrt() / bc2 ** 0.5 + 1e-15))
                ema[k].mul_(decay_ema).add_(p, alpha=1 - decay_ema)
        out["grads"][s] = grads
        out["change"][s] = {k: float(torch.linalg.vector_norm(
            P[k].detach() - P0[k])) for k in P}
        out["ema"][s] = {k: float(torch.linalg.vector_norm(ema[k] - ema0[k]))
                         for k in P}
        del P, P0, m, v, ema, ema0
    return out


# ----------------------------------------------------------------------
# LiDAR frame render
# ----------------------------------------------------------------------

@torch.no_grad()
def render_lidar_frame(c: dict, scene: dict, params, grid, fi: int, device,
                       mm=M.f32_mm, chunk: int = 4096) -> dict:
    """Frame ``fi``'s LiDAR pano from ``params`` and the LiDAR occupancy
    ``grid``: the K' = num_steps_occ_render compacted samples of every
    ray, all composited. Returns numpy depth, raydrop, intensity [H, W]
    (depth in scaled units, as the program returns it)."""
    dev = torch.device(device)
    S = scene
    Hl, Wl = S["panos"].shape[1:3]
    t = torch.tensor(float(S["times"][fi]), dtype=torch.float32, device=dev)
    pose = torch.as_tensor(S["poses_lidar"][fi], device=dev)
    inds = torch.arange(Hl * Wl, device=dev)
    ro, rd = M.to_world(pose, M.lidar_dirs(inds, Hl, Wl, S["intrinsics_lidar"],
                                           S["intrinsics_hoz_lidar"]))
    K = c["num_steps_occ_render"] or c["num_steps_occ"]
    depth, image = [], []
    for i in range(0, ro.shape[0], chunk):
        d, im, _, _ = M.render_rays(params, c, ro[i:i + chunk],
                                    rd[i:i + chunk], t, True, mm, grid, K)
        depth.append(d)
        image.append(im)
    depth = torch.cat(depth).reshape(Hl, Wl)
    image = torch.cat(image).reshape(Hl, Wl, 2)
    return {"depth": depth.cpu().numpy(), "raydrop": image[..., 0].cpu().numpy(),
            "intensity": image[..., 1].cpu().numpy()}
