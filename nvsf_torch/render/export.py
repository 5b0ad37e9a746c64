"""Density-field mesh export: the density on a regular grid, its
iso-surface by marching tetrahedra, and a PLY (counterpart of
``nvsf_tpu/render/export.py``, which rebuilds ``nvsf/nerf/utils.py:
296-384,559-608`` without mcubes or trimesh). The grid is queried on the
trainer's device in chunks (on the card, replays of the chunk's query
captured as a CUDA graph); the iso-surface and the PLY are numpy (each
grid cell split into 6 tetrahedra: no 256-case tables, watertight
output)."""

from __future__ import annotations

import numpy as np
import torch

from nvsf_torch.train.graphs import Program

# the 6-tetrahedra decomposition of a cube (vertex indices into the 8 cube
# corners, corner order: (x, y, z) bits -> index x + 2y + 4z)
_TETS = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7],
])
_CUBE_OFFS = np.array([[x, y, z] for z in (0, 1) for y in (0, 1)
                       for x in (0, 1)])


@torch.no_grad()
def extract_density_grid(trainer, bound_min, bound_max, xyz_res, t=0.0,
                         cal_lidar_color=True, chunk=65536,
                         graphed=None) -> np.ndarray:
    """sigma of the EMA field on a regular grid over [bound_min,
    bound_max] (scene, i.e. scaled, coordinates), ``chunk`` points a query
    on the trainer's device, the last chunk padded with the origin as the
    JAX package's ``q`` pads it. On the card (``graphed`` None or True)
    each chunk replays the query captured as a CUDA graph
    (``train/graphs.py``; the trainer keeps it in ``programs``, dropped on
    a load), the chunk's points and the time its static inputs, and the
    chunks' sigma gathers in one device buffer, read once;
    ``graphed=False`` queries eagerly."""
    dev = trainer.device
    graphed = dev.type == "cuda" if graphed is None else graphed
    xs = np.linspace(bound_min[0], bound_max[0], xyz_res[0])
    ys = np.linspace(bound_min[1], bound_max[1], xyz_res[1])
    zs = np.linspace(bound_min[2], bound_max[2], xyz_res[2])
    pts = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), -1).reshape(-1, 3)
    n = len(pts)
    pts = np.pad(pts, ((0, (-n) % chunk), (0, 0)))
    pts = torch.as_tensor(pts, dtype=torch.float32, device=dev)
    t = torch.tensor(float(t), device=dev)
    field = trainer.ema_field

    def query(pts, t):
        return field.density(pts, t, cal_lidar_color=cal_lidar_color)["sigma"]

    if graphed:
        key = ("density query", chunk, bool(cal_lidar_color))
        if key not in trainer.programs:
            trainer.programs[key] = Program(
                query, dev, held=lambda: list(field.parameters()))
        query = trainer.programs[key]
    sigma = torch.empty(pts.shape[0], device=dev)
    for i in range(0, pts.shape[0], chunk):
        sigma[i:i + chunk].copy_(query(pts=pts[i:i + chunk], t=t))
    return sigma[:n].cpu().numpy().reshape(xyz_res)


def marching_tetrahedra(grid: np.ndarray, threshold: float,
                        bound_min, bound_max):
    """Iso-surface of a scalar grid. Returns (verts [V, 3], faces [F, 3])."""
    nx, ny, nz = grid.shape
    spacing = np.array([
        (bound_max[i] - bound_min[i]) / max(grid.shape[i] - 1, 1)
        for i in range(3)])
    # cell corner coordinates/values, vectorized over all cells
    ix, iy, iz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([ix, iy, iz], -1).reshape(-1, 3)       # [C, 3]
    corner_idx = base[:, None, :] + _CUBE_OFFS[None]       # [C, 8, 3]
    vals = grid[corner_idx[..., 0], corner_idx[..., 1],
                corner_idx[..., 2]]                        # [C, 8]
    # skip cells that don't straddle the threshold
    keep = (vals.max(1) >= threshold) & (vals.min(1) < threshold)
    corner_idx, vals = corner_idx[keep], vals[keep]
    if len(vals) == 0:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    pos = corner_idx * spacing + np.asarray(bound_min)     # [C, 8, 3]

    verts_out = []
    for tet in _TETS:
        tv = vals[:, tet]                                  # [C, 4]
        tp = pos[:, tet]                                   # [C, 4, 3]
        inside = tv >= threshold                           # [C, 4]
        n_in = inside.sum(1)
        for count, flip in ((1, False), (3, True)):
            sel = n_in == count
            if not sel.any():
                continue
            v, p, m = tv[sel], tp[sel], inside[sel]
            if flip:
                m = ~m
            apex = m.argmax(1)
            others = np.argsort(~m, axis=1)[:, 1:]         # 3 non-apex
            tris = []
            for k in range(3):
                a = v[np.arange(len(v)), apex]
                b = v[np.arange(len(v)), others[:, k]]
                w = (threshold - a) / np.where(b - a == 0, 1e-9, b - a)
                pa = p[np.arange(len(p)), apex]
                pb = p[np.arange(len(p)), others[:, k]]
                tris.append(pa + w[:, None] * (pb - pa))
            verts_out.append(np.stack(tris, axis=1))       # [S, 3, 3]
        sel2 = n_in == 2
        if sel2.any():
            v, p, m = tv[sel2], tp[sel2], inside[sel2]
            order = np.argsort(~m, axis=1)
            i0, i1 = order[:, 0], order[:, 1]              # inside
            o0, o1 = order[:, 2], order[:, 3]              # outside
            def lerp(ai, bi):
                a = v[np.arange(len(v)), ai]
                b = v[np.arange(len(v)), bi]
                w = (threshold - a) / np.where(b - a == 0, 1e-9, b - a)
                pa = p[np.arange(len(p)), ai]
                pb = p[np.arange(len(p)), bi]
                return pa + w[:, None] * (pb - pa)
            e00, e01 = lerp(i0, o0), lerp(i0, o1)
            e10, e11 = lerp(i1, o0), lerp(i1, o1)
            verts_out.append(np.stack([e00, e01, e10], axis=1))
            verts_out.append(np.stack([e10, e01, e11], axis=1))
    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    tris = np.concatenate(verts_out, axis=0)               # [T, 3, 3]
    verts, inv = np.unique(tris.reshape(-1, 3).round(7), axis=0,
                           return_inverse=True)
    faces = inv.reshape(-1, 3)
    return verts, faces


def write_ply(path, verts, faces):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for v in verts:
            f.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for fc in faces:
            f.write(f"3 {fc[0]} {fc[1]} {fc[2]}\n")


def export_mesh_density(trainer, bound_min, bound_max, xyz_res, threshold,
                        out_path, t=0.0, log_fn=print):
    """Grid query -> iso-surface -> PLY, the query and the rest timed
    apart as the trainer's stages "mesh query" and "mesh iso-surface"."""
    with trainer.timers.phase("mesh query"):
        grid = extract_density_grid(trainer, bound_min, bound_max, xyz_res,
                                    t=t)
    with trainer.timers.phase("mesh iso-surface"):
        verts, faces = marching_tetrahedra(grid, threshold, bound_min,
                                           bound_max)
        write_ply(out_path, verts, faces)
    if log_fn:
        log_fn(f"[mesh] {len(verts)} verts / {len(faces)} faces -> "
               f"{out_path}")
    return verts, faces
