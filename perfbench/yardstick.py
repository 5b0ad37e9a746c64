"""The benchmark's measures of work: published peaks of one H100, model
FLOPs of a training step, a refresh and a frame, the bytes and operations
of the hand-written kernels' calls, and the kernel families of a device
trace. Everything here is counted from the configuration's widths and the
calls' shapes, never from a clock, so it reads the same work whatever
implements it.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W: 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s float32 on the CUDA cores (an FMA counts
two), 3.35 TB/s HBM3.
"""

from __future__ import annotations

import math

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# the kernels whose calls ``kernel_calls`` counts, by the names of their
# CUDA functions (nvsf_torch/csrc/segsum.cu, multihot.cu)
KERNEL_NAMES = {
    "segment_add": ("segment_add_rows_kernel", "segment_add_transpose_kernel"),
    "multihot_fwd": ("multihot_fwd_kernel",),
    "multihot_bwd": ("multihot_bwd_kernel",),
}


def family(kernel_name: str) -> str:
    """A device kernel's family, for the trace's breakdown."""
    n = kernel_name.lower()
    for key, fam in (("segment_add", "segment_add (B1)"),
                     ("multihot_fwd", "multihot_fwd (B3)"),
                     ("multihot_bwd", "multihot_bwd (B4)"),
                     ("gemm", "gemm"), ("cutlass", "gemm"), ("sm90", "gemm"),
                     ("index", "index/gather/scatter"),
                     ("gather", "index/gather/scatter"),
                     ("scatter", "index/gather/scatter"),
                     ("sort", "sort/scan"), ("scan", "sort/scan"),
                     ("reduce", "reduce")):
        if key in n:
            return fam
    return "elementwise/other"


def bound_s(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S)


# ----------------------------------------------------------------------
# the hand-written kernels' calls
# ----------------------------------------------------------------------

def segment_add(F, M, T):
    """A hash table's gradient: M updates of F features into T slots."""
    return ("segment_add", 4 * M + 4 * F * M + 4 * F * T, F * M)


def multihot_fwd(F, Q, S, C, W, Np):
    ncw = Q * S * C * Np
    return ("multihot_fwd", 4 * F * Q * S * W + 8 * ncw + 4 * Q * S * F * Np,
            2 * ncw * F)


def multihot_bwd(F, Q, S, C, W, Np, need_dw):
    ncw, ntab, nout = Q * S * C * Np, F * Q * S * W, Q * S * F * Np
    return ("multihot_bwd", 8 * ncw + 4 * nout + 4 * ntab
            + (4 * ntab + 4 * ncw if need_dw else 0),
            2 * ncw * F * (2 if need_dw else 1))


def _widths(c):
    Lh, Fh = c["n_levels_hash"], c["n_features_per_level_hash"]
    Lf, Ff = c["flow_n_levels"], c["flow_n_features_per_level"]
    Fp, S = c["n_features_per_level_plane"], c["n_levels_plane"]
    return Lh, Fh, Lf, Ff, Fp, S


def coarse_static_scales(c, max_w=4096) -> int:
    """Scales whose static planes go through the multihot kernel (a plane
    of at most ``max_w`` slots); finer ones are plain gathers."""
    return sum(1 for si in range(c["n_levels_plane"])
               if (c["min_resolution"] * 2 ** si) ** 2 <= max_w)


def density_calls(c, N, grad: bool, warp: bool = True):
    """Kernel calls of one density query at N points: the K-plane
    lookups' forward (and backward), the hash tables' gradients."""
    Lh, Fh, Lf, Ff, Fp, S = _widths(c)
    sc = coarse_static_scales(c)
    q = 3 if warp else 1
    calls = [multihot_fwd(Fp, 1, 3 * sc, 4, 4096, N),
             multihot_fwd(Fp, q, 3 * S, 2, 256, N)]
    if grad:
        calls += [multihot_bwd(Fp, 1, 3 * sc, 4, 4096, N, False),
                  multihot_bwd(Fp, q, 3 * S, 2, 256, N, True),
                  segment_add(Fh, Lh * 8 * N, Lh << c["log2_hashmap_size"]),
                  segment_add(Fh // 4, 3 * Lh * 4 * N,
                              sum(Lh << h for h in c["hash_size_dynamic"]))]
        if warp:
            calls.append(segment_add(Ff // 4, Lf * 8 * N,
                                     Lf << c["flow_log2_hashmap_size"]))
    return calls


def samples_per_step(c):
    """(LiDAR, camera) samples the training step evaluates."""
    if c["render_mode"] == "occupancy":
        kc = c["num_steps_occ_rgb"] or c["num_steps_occ"]
        return (c["num_rays_lidar"] * c["num_steps_occ"], c["num_rays"] * kc)
    return (c["num_rays_lidar"] * c["num_steps"], c["num_rays"] * c["num_steps"])


def step_calls(c, flow_points: int):
    """Kernel calls of one training step; a query in remat chunks runs its
    forward again in the backward."""
    chunks = max(int(c["remat_chunks"]), 1)
    calls = []
    for n in samples_per_step(c):
        per = density_calls(c, n // chunks, grad=True)
        fwd = [x for x in per if x[0] == "multihot_fwd"]
        calls += per * chunks + (fwd * chunks if chunks > 1 else [])
    if c["flow_loss"] and flow_points:
        Lf, Ff = c["flow_n_levels"], c["flow_n_features_per_level"]
        calls.append(segment_add(Ff // 4, Lf * 8 * flow_points,
                                 Lf << c["flow_log2_hashmap_size"]))
    return calls


def refresh_calls(c, update_fraction=None):
    """Kernel calls of one occupancy refresh of both grids: the field's
    density without the warp at G^3 / fraction cells, at each query
    time."""
    frac = update_fraction or c["occ_update_fraction"]
    m = c["occ_grid_size"] ** 3 // frac
    return density_calls(c, m, grad=False, warp=False) \
        * c["occ_time_samples"] * 2


def slab_calls(c):
    """Kernel calls of one slab of the LiDAR frame's marcher."""
    return density_calls(c, c["max_ray_batch"] * c["stream_slab"], grad=False)


def bound_of(calls, kernels=None) -> float:
    return sum(bound_s(b, o) for k, b, o in calls
               if kernels is None or k in kernels)


# ----------------------------------------------------------------------
# model FLOPs: 2 * in * out per MLP layer, 2 per interpolation
# multiply-add of the encoders, per point
# ----------------------------------------------------------------------

def _mlp_flops(dims):
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_dims(c):
    Lh, Fh, Lf, Ff, Fp, S = _widths(c)
    geo = c["geo_feat_dim"]
    sigma_in = 2 * Fp * S + Lh * Fh + 3 * Lh * Fh // 4

    def dims(i, h, o, n):
        return [i] + [h] * (n - 1) + [o]
    return {"sigma": dims(sigma_in, c["hidden_dim_sigma"], 1 + geo,
                          c["num_layers_sigma"]),
            "flow": dims(Lf * Ff // 4, c["hidden_dim_flow"], 6,
                         c["num_layers_flow"]),
            "lidar_head": dims(72 + geo, c["hidden_dim_lidar"], 1,
                               c["num_layers_color"]),
            "color": dims(16 + geo, c["hidden_dim_color"], 3,
                          c["num_layers_color"])}


def point_flops(c, lidar: bool, warp: bool = True) -> float:
    """Forward FLOPs of the field (density and the branch's color head)
    at one point."""
    Lh, Fh, Lf, Ff, Fp, S = _widths(c)
    d = mlp_dims(c)
    q = 3 if warp else 1
    enc = 2 * Lh * 8 * Fh                          # static hash, trilinear
    enc += q * 2 * 3 * Lh * 4 * (Fh // 4)          # dynamic hash, bilinear
    enc += 2 * 3 * S * 4 * Fp                      # static planes
    enc += q * 2 * 3 * S * 4 * Fp                  # dynamic planes
    f = enc + _mlp_flops(d["sigma"])
    if warp:
        f += 2 * Lf * 8 * (Ff // 4) + _mlp_flops(d["flow"])
    f += 2 * _mlp_flops(d["lidar_head"]) if lidar else _mlp_flops(d["color"])
    return f


def step_flops(c, flow_points: int = 0) -> float:
    """Model FLOPs of one training step, forward and backward (x3)."""
    nl, nc = samples_per_step(c)
    f = nl * point_flops(c, True) + nc * point_flops(c, False)
    if c["flow_loss"] and flow_points:
        d = mlp_dims(c)
        f += flow_points * (2 * c["flow_n_levels"] * 8
                            * (c["flow_n_features_per_level"] // 4)
                            + _mlp_flops(d["flow"]))
    return 3 * f


def refresh_flops(c, update_fraction=None) -> float:
    """Model FLOPs of one refresh of both grids (density only)."""
    frac = update_fraction or c["occ_update_fraction"]
    m = c["occ_grid_size"] ** 3 // frac
    d = mlp_dims(c)
    per = point_flops(c, True, warp=False) - 2 * _mlp_flops(d["lidar_head"])
    return 2 * c["occ_time_samples"] * m * per


def slab_flops(c) -> float:
    """Model FLOPs of one marcher slab of a LiDAR frame."""
    return c["max_ray_batch"] * c["stream_slab"] * point_flops(c, True)


def frame_slabs(c, n_rays: int) -> int:
    """Slabs in a LiDAR frame's chunks: rays padded to whole compaction
    chunks of 8192, cut into chunks of ``max_ray_batch``, each of
    K' / stream_slab slabs."""
    cc = min(8192, n_rays)
    padded = math.ceil(n_rays / cc) * cc
    chunk = min(c["max_ray_batch"], padded)
    k = c["num_steps_occ_render"] or c["num_steps_occ"]
    s = min(c["stream_slab"], k)
    return math.ceil(padded / chunk) * math.ceil(k / s)
