"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase render    # phase 13 alone (~3 min)
    python3 chip_smoke.py --phase programs  # phase 14 alone
    python3 chip_smoke.py --phase hash      # phase 15 alone (~1 min)

Phases, one line each:
  1. card     -- a CUDA device is present; prints nvidia-smi's name and
                 power limit.
  2. build    -- compiles the kernels of nvsf_torch/csrc with nvcc, one
                 process per source, all at once.
  3. kernels  -- each kernel against its plain PyTorch version at the
                 shapes its path gives it (the training step's for B1-B4,
                 the eval frame's 67,980 x 67,980 points for B5), with its
                 time, the plain version's, one PyTorch library call's
                 and the card's bound for the same work; then phase 15's
                 rows of the hash-grid lookup. Its "step" rows (run after
                 phase 4, on its trainer) hold the hash-grid lookup's
                 forward and its gradient (B1's rows stage, fused), B4,
                 and B3's forward, to the same checks and times on the
                 inputs of one real training step, captured by wrapping
                 the kernels' wrappers for that step (B1's cols/vals
                 entry, which no step runs on the card, has phase 3's
                 rows alone); its "eval" rows (run after phase 5) hold B3
                 to them on the inputs of one render slab of phase 5's
                 field; its "uniform" rows (after phase 8) hold the
                 lookup, B3 and B4 to them on the inputs of one remat
                 chunk of a dense step; its "programs" rows (in
                 phase 14) hold B3 to them on the inputs of one refresh
                 and of one density-query chunk. The inputs of these rows
                 come from eager steps (use_scan=False): a captured step's
                 tensors are static buffers that its next replay
                 overwrites.
  4. slice    -- the joint LiDAR + camera training step (the bench.py
                 "joint-tuned" rung at full width on the synthetic scene):
                 Trainer.train_one_epoch for one random and one patch
                 epoch (the scanned epoch: each mode's step captured as a
                 CUDA graph after two eager warm-ups, then replayed), then
                 timed steady-state steps, eager and graphed in turns, and
                 a torch.profiler breakdown of each one's device time by
                 kernel family, its kernels a step and peak memory.
  5. eval     -- phase 4's field trained 6 more epochs and its occupancy
                 grids settled (bench.py's render rung), then evaluate() of
                 its trained parameters on the full-width val frame: the
                 streaming occupancy marcher, each frame a replay of the
                 renderer's frame graphs (render/frame_graph.py), the
                 meters (B5 behind the PointsMeter), the JSON error
                 matrices, no host read between slabs; the graphed LiDAR
                 frame timed and profiled; one chunk of rays rendered on
                 the card and on the CPU and compared; B5 against its plain
                 version on that render and its ground truth; one frame
                 rendered from the EMA parameters, evaluate's default.
                 Phase 13 runs next, on this field.
  6. learning -- the small convergence drive of the verify notes (8
                 epochs, 4 frames) must cut the loss below 0.7x.
  7. cli      -- configs/kitti360_1908.txt through the port's CLI
                 (nvsf_torch.scripts.main_nvsf.main) on the synthetic
                 scene: 12 epochs with evals and checkpoints every 4 and a
                 device trace, the U-Net refine and the refined eval; then
                 --test --test_eval --use_refine from the refine checkpoint
                 with a novel sensor (a scene without ground truth: the
                 test run renders and exports, and scores nothing), and
                 the mesh export. Checks the losses, that no epoch was
                 retried, the checkpoints, refine loss, refined meters,
                 novel pano size, mesh faces and trace, that the refine
                 stage replayed its captured step (after 2 eager ones) and
                 the mesh export its captured density query; prints each
                 stage's wall time (the mesh's query and iso-surface
                 apart) and the path's kernel launches (the replays' B3
                 among them); holds one eval-mode U-Net forward on the
                 card to the CPU's. The script runs cuDNN in f32
                 (cudnn.allow_tf32 False); the CLI alone keeps torch's
                 default, TF32 convolutions.
  8. uniform  -- the dense uniform render mode (the JAX package's default)
                 at phase 4's width: 768 samples a ray through the field,
                 the density query in 8 remat chunks. Timed random and
                 patch steps with a torch.profiler breakdown and the peak
                 memory, eager and graphed (its capture time); one f32
                 step with 8 chunks and with 1, equal
                 (B2 on the path); one dense chunk on the card and on the
                 CPU; evaluate() of the trained field, dense and graphed
                 (B5 behind the PointsMeter), the LiDAR frame render timed
                 beside phase 5's marcher; the convergence drive of phase 6
                 in uniform mode.
  9. kitti    -- raw KITTI-360 to a scored field with the port alone: a raw
                 tree of sequence 1908 (calibration, poses, 64 HDL-64E-like
                 Velodyne sweeps, camera PNGs at 1/4 size, a 3D box XML)
                 through `python -m nvsf_torch.scripts.preprocess_data`
                 (stage times; native range views held to numpy's), then
                 the CLI on the config it wrote at the shipped widths: 1
                 epoch and the eval of the val frames (finite CD, F,
                 PSNR), the image-load time and the path's launches.
 10. joint    -- the joint_fusion step (bench.py's joint-8x4 rung) against
                 the separate step on one trainer: equal losses in bf16,
                 equal gradients in f32 (1e-5 of each gradient's max), and
                 each step's time, device time, kernels, busy share and
                 peak memory, in turns, and the fused step graphed. Phase
                 3's "joint" rows hold B1, B3 and B4 on one fused step's
                 inputs.
 11. parallel -- ray-sharded data parallelism (nvsf_torch.parallel.mesh):
                 (a) two ranks on the one card over gloo, spawned from here,
                 at phase 4's width: one f32 step's gradients (the mean over
                 the ranks, before Adam) against one process's (1e-5 of
                 each gradient's max), 8 bf16 steps (a random and a patch
                 epoch, two grid refreshes; use_scan=False, as gloo's
                 collectives cannot be captured) after which every
                 replicated
                 tensor is bit for bit equal on both ranks, the val frame
                 rendered sharded through evaluate() (B5 behind its
                 PointsMeter) against rank 0's render of it alone, the
                 collectives a step and the step time; (b) phase 7's argv
                 through the CLI with --mesh_shape 1 (one rank over NCCL,
                 its step and collectives captured), 2 epochs, raydrop threshold 0, the val evals and 20
                 refine steps: each checkpoint written once, finite
                 error matrices; the
                 "parallel" launches are both runs' ranks'.
 12. graph    -- the captured step against the eager step, f32 at phase
                 4's width: a trainer stepping through Trainer.scan_step
                 (two eager warm-ups a mode, then replays) and a second one
                 stepping eagerly, the second given the first's state and
                 generator state before each step; 8 random steps (grid
                 refreshes after steps 4 and 8) and 3 patch steps. Each
                 step's loss, every gradient, the error-map rows and the
                 refreshed grids agree within 1e-5 of each tensor's max;
                 the learning rates a replay reads follow the schedule;
                 the replays draw the eager step's rays, and consecutive
                 replays different ones.
 13. render   -- (run after phase 5, on its settled field) the frame
                 renders as CUDA graphs against the eager renders on the
                 card (Renderer.render_eager: the same kernels, every slab
                 gated on the device): the LiDAR and camera frames,
                 occupancy and dense, from the live and the EMA renderer,
                 each output within 1e-6 of its max, the same slabs run;
                 a LiDAR frame at another pose and time replayed under
                 set_sync_debug_mode("error"); a grid emptied in place read
                 by the next replay; rays/s graphed and eager, slabs run
                 against 36 x 6, capture times, each capture's growth of
                 the pools that both renderers' graphs share, and the
                 pools; a replay's B3 launches (counted on the device in
                 the IF bodies that ran) against the eager frame's per
                 slab; a training epoch with the render pools resident,
                 its peak memory. Phase 3's "graph_if" row holds the IF
                 node (csrc/graph_cond.cu) to the gated update.
 14. programs -- (run after phase 13, on phase 5's field) the JAX package's
                 last jitted programs, each captured as a CUDA graph
                 (nvsf_torch/train/graphs.py), against its eager version
                 on the card: (a) the occupancy refresh at the shipped
                 cadence (G 128, 1/16 of the cells, 4 times, both grids),
                 the grids at 2 seeds within 1e-6 of their max; (b) the
                 U-Net refine step at the bench scene's shape [15, 3, 66,
                 1030] (phase 5's LiDAR frame tiled, plus seeded noise):
                 2 eager warm-ups and 20 replays against eager steps from
                 the same state, loss, gradients and BatchNorm statistics
                 within 1e-5 of each tensor's max, and the parameters and
                 Adam moments after the eager Adam step taken again on the
                 replay's gradients, each side's own-step parameters
                 reported beside a second eager copy's (two eager runs
                 differ there too); timed in f32 and with cuDNN's TF32;
                 (c) the mesh export's density query
                 of the default 256 x 256 x 32 grid (32 chunks), sigma
                 within 1e-6 of its max, its device time 32 times one
                 profiled chunk's, the iso-surface timed apart; (d)
                 the EMA update, one call, bit-equal to the loop. Each
                 program replayed once under set_sync_debug_mode("error");
                 wall and device time, kernels and busy share, eager and
                 graphed in turns; captures and pools. Its path
                 ("programs") is one graphed refresh and one graphed query
                 of the mesh grid.
 15. hash     -- (in phase 3; alone: --phase hash) the hash-grid lookup
                 (ops/hash_lookup.py: csrc/hash_encode.cu and its gradient
                 in B1's rows stage) at the encoder shapes of the
                 benchmark's two training cells, on ray-ordered points:
                 forward and gradient against the plain composition (the
                 chain the kernels replace), their device times, the
                 bound (points read, features written, table sectors
                 touched; the gradient's table written whole), launches a
                 call; and the layouts: the forward reading the
                 features-major table in place against the row-major copy
                 and the copy's time, and the folds writing either layout.

Each phase prints when it is done, with its share of the script's 600 s
target (half the 1200 s allowed).

Any failure raises and the script exits non-zero. The line before the
last is a JSON record of the kernels (B1 and B2, one kernel with a
precision flag, as two entries; "graph_if", the IF node's kernel, which
replaces no Pallas kernel but the condition of a lax.while_loop); the
last is
{"ok": true, "device": {...}}. Needs one GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import re
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as nnf

from nvsf_torch.config import NVSFConfig
from nvsf_torch.ops import chamfer
from nvsf_torch.ops import kernels
from nvsf_torch.ops import multihot as mh
from nvsf_torch.ops import segsum
from nvsf_torch.train.step_graph import WARMUP_STEPS

# Relative error bound of an f32 sum, per unit of the sum of the magnitudes
# of its terms: k additions in sequence round by at most k * 2^-24 of it,
# under 1e-5 for k up to ~160. The random inputs put a few dozen terms in a
# slot. On a step's ray-ordered samples a column of the narrowest K-planes
# (32 wide) takes ~16k terms: the multihot kernels add them in warp runs
# (a tree), one shared atomic per run and one global atomic per block, but a
# plain version in f32 adds them one by one and strays further than the
# kernel, so the multihot checks evaluate the plain version in f64.
SUM_RTOL = 1e-5

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# HBM3 rate, and f32 on the CUDA cores with an FMA counted as two flops.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

TRAIN_KERNELS = ("hash_encode_fwd", "hash_encode_bwd", "multihot_fwd",
                 "multihot_bwd")

# the script's own time target, half the 1200 s it is allowed
TARGET_S = 600.0


def bound(nbytes: float, flops: float):
    """The least time the card could take for the work, in ms: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its flops over the f32 rate; and which of them it is."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / FP32_FLOP_PER_S * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


@contextlib.contextmanager
def watch_lidar_sweep():
    """Inside the block, record the frames ``evaluate`` renders through
    its LiDAR sweep ("out") and the sweep's synchronised wall time
    ("seconds"; the sweep ends in a host copy)."""
    import nvsf_torch.train.evaluate as ev
    orig, seen = ev.render_lidar_sweep, {}

    def sweep(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["out"] = orig(*args, **kwargs)
        seen["seconds"] = time.perf_counter() - t0
        return seen["out"]

    ev.render_lidar_sweep = sweep
    try:
        yield seen
    finally:
        ev.render_lidar_sweep = orig


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Device time per call of ``fn`` over ``reps`` calls run back to back
    on the device: a spin kernel holds the stream while the host queues
    the calls between two CUDA events. ``cuda_ms`` times the host's launches
    instead wherever a call takes the host longer than its kernels take the
    device."""
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22                 # ~2 ms at the H100's clock
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()     # the spin still ran when all were queued
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4


def compare(name, got, ref, mags):
    """max |got - ref| against SUM_RTOL * max(mags), where ``mags`` is
    the sum of the magnitudes of the terms of each output."""
    err = float((got - ref).abs().max())
    tol = SUM_RTOL * float(mags.abs().max()) + 1e-7
    ok = np.isfinite(err) and err <= tol
    return err, tol, ok


# ----------------------------------------------------------------------
# phase 1 and 2
# ----------------------------------------------------------------------

def phase_card():
    if not torch.cuda.is_available():
        print("[card] torch.cuda.is_available() is False: this check needs "
              "an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}"
                f" cuda {torch.version.cuda}; count "
                f"{torch.cuda.device_count()}")
    print(smi, flush=True)
    return smi


def phase_build():
    t0 = time.perf_counter()
    kernels.library()
    dt = time.perf_counter() - t0
    info = kernels.build_info
    log("build", f"{dt:.1f} s (nvcc {info.get('seconds', 0):.1f} s) -> "
                 f"{info.get('path')}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("build", line.strip())


# ----------------------------------------------------------------------
# phase 3: each kernel against its plain version at main-path shapes
# ----------------------------------------------------------------------

def _segment_add_cases(gen, dev):
    """(name, cols, vals, T) of the three table gradients of the LiDAR
    step (N = 2048 x 96 samples), from the slice's own encoders:
      static hash   4 levels x 8 corners x N updates, F 8, T 4 x 2^19;
      flow hash     the same M, F 32 / 4 basis = 8, T 4 x 2^18;
      dynamic hash  3 planes x 4 levels x 4 corners x N updates, F 2,
                    T 4 x (2^15 + 2^13 + 2^13)."""
    from nvsf_torch.models.field import NVSFField
    from nvsf_torch.train.trainer import field_spec_from_config
    field = NVSFField(field_spec_from_config(joint_tuned_config(
        slice_spec())), generator=torch.Generator().manual_seed(0))
    x = torch.rand((2048 * 96, 3), generator=gen, device=dev)

    def randn(F, M):
        return torch.randn((F, M), generator=gen, device=dev)

    static = field.hash_lidar.static_grid
    cols, _ = static.level_cols_weights(x)
    cases = [("static hash", cols,
              randn(static.n_features_per_level, cols.shape[0]),
              static.n_cols)]
    flow = field.flow.enc
    cols, _ = flow.level_cols_weights(x)
    cases.append(("flow hash", cols,
                  randn(flow.n_features_per_level // field.flow.num_basis,
                        cols.shape[0]), flow.n_cols))
    from nvsf_torch.ops import hash_lookup as hl
    grids = field.hash_lidar.dynamic_grids
    res = field.hash_lidar.static_grid.resolutions
    cols = torch.cat([hl.level_cols_weights(x[:, list(pl.axes)], res,
                                            1 << pl.log2_T)[0] + pl.slot0
                      for pl in field.hash_lidar._planes()])
    cases.append(("dynamic hash", cols,
                  randn(grids[0].n_features_per_level // grids[0].num_basis,
                        cols.shape[0]),
                  sum(gr.grid.n_cols for gr in grids)))
    return cases


def segment_add_row(variant, cols, vals, T, prec):
    """B1 (bf16) or B2 (f32) on one input against its plain version, with
    its time, the plain version's, index_add's and the bound."""
    F, M = vals.shape
    got = segsum.segment_add_cuda(cols, vals, T, prec)
    ref = segsum.segment_add_plain(cols, vals, T, prec)
    bnd = segsum.segment_add_plain(cols, vals.abs(), T, "f32")
    err, tol, ok = compare(f"segment_add[{prec}]", got, ref, bnd)
    zeros = torch.zeros((F, T), device=vals.device)
    b_ms, b_by = bound(4 * M + 4 * F * M + 4 * F * T, F * M)
    return dict(
        variant=f"{variant} {prec} M={M} F={F} T={T} ld={vals.stride(0)}",
        max_abs_err=err, tol=tol, ok=ok,
        ms=cuda_ms(lambda: segsum.segment_add_cuda(cols, vals, T, prec)),
        plain_ms=cuda_ms(lambda: segsum.segment_add_plain(cols, vals, T,
                                                          prec)),
        # index_add into zeros: the f32 sum, without B1's rounding
        library_ms=cuda_ms(lambda: torch.index_add(zeros, 1, cols, vals)),
        bound_ms=b_ms, bound_by=b_by)


def check_segment_add(gen, dev):
    """B1 (bf16) and B2 (its f32 flag) at each table-gradient shape of the
    step."""
    return [segment_add_row(name, cols, vals, T, prec)
            for name, cols, vals, T in _segment_add_cases(gen, dev)
            for prec in ("bf16", "f32")]


def _multihot_inputs(Q, S, C, W, F, Np, gen, dev, lerp):
    tables = torch.rand((F, Q * S * W), generator=gen, device=dev)
    if lerp:   # the dynamic planes' x-lerp corners: x0 and x0 + 1
        x0 = torch.randint(0, W - 1, (Q, S, 1, Np), generator=gen,
                           device=dev, dtype=torch.int32)
        cols = torch.cat([x0, x0 + 1], dim=2)
        wx = torch.rand((Q, S, 1, Np), generator=gen, device=dev)
        ws = torch.cat([1 - wx, wx], dim=2)
    else:      # the coarse static planes' 4 bilinear corners
        cols = torch.randint(0, W, (Q, S, C, Np), generator=gen, device=dev,
                             dtype=torch.int32)
        ws = torch.rand((Q, S, C, Np), generator=gen, device=dev)
    g = torch.randn((Q, S, F, Np), generator=gen, device=dev)
    return tables, cols.contiguous(), ws.contiguous(), g


def _bags(tables, cols, ws, g, W, need_dw):
    """The multihot inputs in embedding_bag's layout, made outside the
    timed region: weight [Q*S*W, F], bags [Q*S*Np, C] of global columns
    (cols + segment offset), their weights, and the output gradient
    [Q*S*Np, F] (None without ``g``)."""
    Q, S, C, Np = cols.shape
    seg = (torch.arange(Q * S, device=cols.device) * W).reshape(Q, S, 1, 1)
    idx = (cols.long() + seg).permute(0, 1, 3, 2).reshape(-1, C).contiguous()
    psw = ws.permute(0, 1, 3, 2).reshape(-1, C).contiguous()
    weight = tables.t().contiguous().requires_grad_(True)
    psw_g = psw.clone().requires_grad_(need_dw)
    gb = None if g is None else \
        g.permute(0, 1, 3, 2).reshape(-1, tables.shape[0]).contiguous()
    return idx, psw, weight, psw_g, gb


def multihot_fwd_row(desc, tables, cols, ws, W):
    """B3 on one input against its plain version (evaluated in f64, see
    SUM_RTOL), with its time (CUDA events, and the device time of its
    kernels), the plain version's (in f32), embedding_bag's and the
    bound."""
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    got = mh.multihot_fwd_cuda(tables, cols, ws, W)
    ref = mh.multihot_fwd_plain(tables.double(), cols, ws.double(), W)
    bnd = mh.multihot_fwd_plain(tables.abs(), cols, ws.abs(), W)
    err, tol, ok = compare("multihot_fwd", got, ref, bnd)
    del got, ref, bnd
    idx, psw, weight, _, _ = _bags(tables, cols, ws, None, W, False)
    b_ms, b_by = bound(4 * tables.numel() + 8 * cols.numel()
                       + 4 * Q * S * F * Np, 2 * cols.numel() * F)
    return dict(
        variant=desc, max_abs_err=err, tol=tol, ok=ok,
        ms=cuda_ms(lambda: mh.multihot_fwd_cuda(tables, cols, ws, W)),
        device_ms=device_ms(lambda: mh.multihot_fwd_cuda(tables, cols, ws,
                                                         W)),
        plain_ms=cuda_ms(lambda: mh.multihot_fwd_plain(tables, cols, ws, W)),
        library_ms=cuda_ms(lambda: nnf.embedding_bag(
            idx, weight.detach(), mode="sum", per_sample_weights=psw)),
        bound_ms=b_ms, bound_by=b_by)


def multihot_rows(desc, tables, cols, ws, g, W, need_dw):
    """B3 and B4 on one input against their plain versions (evaluated in
    f64, see SUM_RTOL), with their times, the plain versions' (in f32),
    embedding_bag's (forward and backward) and the bounds: (forward row,
    backward row)."""
    Q, S, C, Np = cols.shape
    F = tables.shape[0]
    fwd = multihot_fwd_row(desc, tables, cols, ws, W)
    t64, w64, g64 = tables.double(), ws.double(), g.double()
    idx, psw, weight, psw_g, gb = _bags(tables, cols, ws, g, W, need_dw)
    n_tab, n_cw = tables.numel(), cols.numel()
    n_out = Q * S * F * Np
    dt, dw = mh.multihot_bwd_cuda(tables, cols, ws, g, W, need_dw)
    rdt, rdw = mh.multihot_bwd_plain(t64, cols, w64, g64, W, need_dw)
    del t64, w64, g64
    bdt, bdw = mh.multihot_bwd_plain(tables.abs(), cols, ws.abs(), g.abs(),
                                     W, need_dw)
    err, tol, ok = compare("multihot_bwd.dT", dt, rdt, bdt)
    if need_dw:
        e2, t2, ok2 = compare("multihot_bwd.dw", dw, rdw, bdw)
        if e2 / t2 > err / tol:
            err, tol = e2, t2
        ok = ok and ok2
    bag = nnf.embedding_bag(idx, weight, mode="sum", per_sample_weights=psw_g)
    wrt = [weight, psw_g] if need_dw else [weight]
    # reads cols, ws, g (and the tables for dw); writes dT (and dw)
    b_ms, b_by = bound(
        8 * n_cw + 4 * n_out + 4 * n_tab
        + (4 * n_tab + 4 * n_cw if need_dw else 0),
        2 * n_cw * F * (2 if need_dw else 1))
    bwd = dict(
        variant=desc + (" need_dw" if need_dw else " table-only"),
        max_abs_err=err, tol=tol, ok=ok,
        ms=cuda_ms(lambda: mh.multihot_bwd_cuda(tables, cols, ws, g, W,
                                                need_dw)),
        plain_ms=cuda_ms(lambda: mh.multihot_bwd_plain(tables, cols, ws, g,
                                                       W, need_dw)),
        library_ms=cuda_ms(lambda: torch.autograd.grad(
            bag, wrt, gb, retain_graph=True)),
        bound_ms=b_ms, bound_by=b_by)
    return fwd, bwd


def check_multihot(gen, dev):
    """B3 and B4 at the two plane shapes of the step, each at the LiDAR
    (N = 2048 x 96) and the camera (N = 2048 x 128) sample count: coarse
    static planes (Q 1, S 6, C 4, W 4096, table gradient only) and dynamic
    planes after the scalar-t fold (Q 3, S 12, C 2, W 256, with the weight
    gradient)."""
    fwd_rows, bwd_rows = [], []
    shapes = [dict(Q=1, S=6, C=4, W=4096, need_dw=False, lerp=False),
              dict(Q=3, S=12, C=2, W=256, need_dw=True, lerp=True)]
    for sh, N in [(sh, N) for sh in shapes for N in (2048 * 96, 2048 * 128)]:
        Q, S, C, W = sh["Q"], sh["S"], sh["C"], sh["W"]
        tables, cols, ws, g = _multihot_inputs(Q, S, C, W, 8, N, gen, dev,
                                               sh["lerp"])
        fwd, bwd = multihot_rows(
            f"Q={Q} S={S} C={C} W={W} F=8 Np={cols.shape[-1]}",
            tables, cols, ws, g, W, sh["need_dw"])
        fwd_rows.append(fwd)
        bwd_rows.append(bwd)
    return fwd_rows, bwd_rows


# B5 tolerance, per query: each of the kernel and its plain version rounds
# the squares, the 3-term dot product and two additions of
# |a|^2 + |b|^2 - 2 a.b, ~10 * 2^-24 * (|a_i|^2 + |b_j|^2) apiece (the
# kernel's FMAs round less often). Either version's min is then within
# both errors of the true min at its own argmin and at the other's (a
# different argmin within that error gives a min within it too). c = 32
# covers both evaluations and leaves room for the summation order of
# cuBLAS's product in the plain one. Only points within sqrt(ref_i) + 1 m
# of a_i can be an argmin of either version (any other is over 1 m^2 worse
# than the min, far beyond both errors), so |b_j| <= |a_i| + sqrt(ref_i) + 1.
B5_C = 32


def b5_compare(a, b, am=None, bm=None):
    """B5 both ways against its plain version: per unmasked query (both
    directions concatenated) |kernel - plain|, the tolerance above and the
    plain distance."""
    d1, d2 = chamfer.chamfer_distance(a, b, am, bm)
    diffs, tols, refs = [], [], []
    for got, x, y, xm, ym in ((d1, a, b, am, bm), (d2, b, a, bm, am)):
        ref = chamfer.min_dist2_plain(x, y, ym)
        keep = torch.ones_like(ref, dtype=torch.bool) if xm is None else xm
        ref = torch.where(keep, ref, 0.0)
        xn = x.norm(dim=-1)
        tol = B5_C * 2.0 ** -24 * (xn * xn + (xn + ref.sqrt() + 1.0) ** 2)
        diffs.append((got - ref).abs()[keep])
        tols.append(tol[keep])
        refs.append(ref[keep])
    return tuple(torch.cat(v) for v in (diffs, tols, refs))


def b5_stats(diff, tol, ref):
    """Worst err/tol with its error and tolerance, and ref/tol at its 1st
    percentile and median: how far the compared distances stand above the
    tolerance, i.e. how wrong a kernel could be and still pass."""
    ratio = diff / tol
    i = int(ratio.argmax())
    teeth = torch.quantile((ref / tol).double(),
                           torch.tensor([0.01, 0.5], dtype=torch.float64,
                                        device=ref.device))
    return dict(max_abs_err=float(diff.max()), tol=float(tol[i]),
                err_over_tol=float(ratio[i]),
                ref_over_tol_p01=float(teeth[0]),
                ref_over_tol_median=float(teeth[1]),
                ok=bool(torch.isfinite(ratio).all() and ratio[i] <= 1.0))


def b5_flops(na: int, nb: int) -> int:
    """B5's work as the f32 bound counts it: 3 FMAs and 1 min per (query,
    valid point) pair, each way. These are 4 issued instructions, and the
    card issues at most 128 f32 instructions per clock per SM (the FMA's
    rate), so each counts as an FMA's 2 flops."""
    return 2 * (4 * 2) * na * nb


def _chamfer_clouds(gen, dev):
    """The eval frame's shape: every pixel of a 66 x 1030 pano of the
    synthetic scene as a point in metres (dropped rays at the 80 m range),
    and a copy moved by N(0, 1 m) per axis, so that the nearest distances
    stand well above the tolerance."""
    from nvsf_torch.data.synthetic import make_synthetic_scene
    from nvsf_torch.lib import convert
    spec = slice_spec()
    scene = make_synthetic_scene(spec, split="val")
    depth = scene.images_lidar[0][:, :, 2] / spec.scale
    depth = np.where(depth > 0, depth, spec.max_depth)
    a = convert.pano_direction_grid(scene.H_lidar, scene.W_lidar,
                                    scene.intrinsics_lidar,
                                    scene.intrinsics_hoz_lidar) \
        * depth[..., None]
    a = torch.as_tensor(a.reshape(-1, 3), dtype=torch.float32, device=dev)
    b = a + torch.randn(a.shape, generator=gen, device=dev)
    return a.contiguous(), b.contiguous()


def _library_min_dist2(a, b, block=8192):
    """min_j |a_i - b_j|^2 by torch.cdist over blocks of 8192 b points:
    one cdist and one amin per block (no single PyTorch call computes it)."""
    best = None
    for j in range(0, b.shape[0], block):
        d = torch.cdist(a, b[j:j + block]).amin(dim=1)
        best = d if best is None else torch.minimum(best, d)
    return best * best


def check_chamfer(gen, dev):
    """B5 both ways at the eval frame's 67,980 x 67,980 points, without
    masks (as the PointsMeter calls it) and with ~10 % of each cloud
    masked out."""
    a, b = _chamfer_clouds(gen, dev)
    rows = []
    for masked in (False, True):
        am = bm = None
        if masked:
            am = torch.rand(a.shape[0], generator=gen, device=dev) >= 0.1
            bm = torch.rand(b.shape[0], generator=gen, device=dev) >= 0.1
        st = b5_stats(*b5_compare(a, b, am, bm))
        av = a if am is None else a[am].contiguous()
        bv = b if bm is None else b[bm].contiguous()
        # a check that a kernel returning ~0 or off by the whole distance
        # would pass is no check: the distances must stand above the tolerance
        st["ok"] = st["ok"] and st["ref_over_tol_median"] >= 10.0
        N, M = a.shape[0], b.shape[0]
        na = N if am is None else int(am.sum())
        nb = M if bm is None else int(bm.sum())
        b_ms, b_by = bound(16 * (N + M) + (N + M if masked else 0),
                           b5_flops(na, nb))
        rows.append(dict(
            variant=f"both ways, N={N} M={M}"
                    + (f", masked to {na} / {nb}" if masked else ""),
            **st,
            ms=cuda_ms(lambda: chamfer.chamfer_distance(a, b, am, bm)),
            plain_ms=cuda_ms(lambda: (chamfer.min_dist2_plain(a, b, bm),
                                      chamfer.min_dist2_plain(b, a, am)),
                             reps=3),
            # over the valid points of each cloud, selected outside the
            # timed calls
            library_ms=cuda_ms(lambda: (_library_min_dist2(av, bv),
                                        _library_min_dist2(bv, av)), reps=3),
            bound_ms=b_ms, bound_by=b_by))
    return rows


KERNELS = [
    # name, C source, TPU kernel it replaces
    ("segment_add", "nvsf_torch/csrc/segsum.cu",
     "nvsf_tpu/ops/segsum.py:102"),
    ("segment_add_f32", "nvsf_torch/csrc/segsum.cu",
     "nvsf_tpu/ops/segsum.py:42"),
    ("multihot_fwd", "nvsf_torch/csrc/multihot.cu",
     "nvsf_tpu/ops/multihot.py:33"),
    ("multihot_bwd", "nvsf_torch/csrc/multihot.cu",
     "nvsf_tpu/ops/multihot.py:47"),
    ("chamfer_min_dist", "nvsf_torch/csrc/chamfer.cu",
     "nvsf_tpu/ops/chamfer_pallas.py:32"),
    # not a Pallas kernel: the hash-grid lookup's XLA ops (corners, hash,
    # weights, gather, corner sum)
    ("hash_encode_fwd", "nvsf_torch/csrc/hash_encode.cu",
     "nvsf_tpu/models/hash_grid.py:142"),
    # its gradient: B1's rows stage with the lookup's input stage
    ("hash_encode_bwd", "nvsf_torch/csrc/segsum.cu",
     "nvsf_tpu/ops/segsum.py:102"),
    # not a Pallas kernel: the condition of the marcher's lax.while_loop
    # (slab_cond), which the frame graphs' IF nodes decide on the device
    ("graph_if", "nvsf_torch/csrc/graph_cond.cu",
     "nvsf_tpu/render/renderer.py:624"),
]


def check_graph_if(gen, dev, n=216):
    """The IF node (``frame_graph.if_node``: the kernel that sets a
    conditional node from a device bool, and the node) against its plain
    version, the gated update the eager marcher makes: a graph of ``n`` IF
    nodes (36 chunks x 6 slabs, a LiDAR frame's), each adding one to its
    own counter where its own bool holds, replayed on two draws of random
    bools against torch.where(pred, x + 1, x). Times per node: a replay
    over ``n``, and the plain version's ``n`` gated updates over ``n``; the
    bound is the one byte each node reads."""
    from nvsf_torch.render.frame_graph import if_node
    preds = torch.zeros(n, dtype=torch.bool, device=dev)
    x = torch.zeros(n, dtype=torch.int64, device=dev)
    body_stream, body_pool = torch.cuda.Stream(dev), torch.cuda.MemPool()
    side = torch.cuda.Stream(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side,
                          capture_error_mode="thread_local"):
        for i in range(n):
            with if_node(preds[i], body_stream, body_pool):
                x[i:i + 1].add_(1)
    err = 0
    for _ in range(2):
        preds.copy_(torch.rand(n, generator=gen, device=dev) < 0.5)
        x.zero_()
        graph.replay()
        ref = torch.where(preds, 1, 0)
        err = max(err, int((x - ref).abs().max()))
    ms = cuda_ms(graph.replay) / n

    def plain():
        for i in range(n):
            x[i:i + 1].copy_(torch.where(preds[i], x[i:i + 1] + 1,
                                         x[i:i + 1]))

    plain_ms = cuda_ms(plain, reps=3) / n
    b_ms, b_by = bound(1, 0)
    # counts: any difference is a whole count, so tol 0.5 asks for equality
    return [dict(variant=f"{n} IF nodes, one bool each", max_abs_err=err,
                 tol=0.5, ok=err == 0, ms=ms, plain_ms=plain_ms,
                 library_ms=None, bound_ms=b_ms, bound_by=b_by)]


def _fmt_ms(v):
    return "n/a" if v is None else f"{v:.4f} ms"


def _fmt_teeth(st):
    return (f"; worst err/tol {st['err_over_tol']:.3e}, ref/tol p01 "
            f"{st['ref_over_tol_p01']:.3g} median "
            f"{st['ref_over_tol_median']:.3g}")


def report_kernels(rows, tag="kernels"):
    """Log each row; raise if any disagrees with its plain version."""
    bad = []
    for name, rs in rows.items():
        for r in rs:
            dev = (f" (device {r['device_ms']:.4f} ms)"
                   if "device_ms" in r else "")
            log(tag, f"{name} [{r['variant']}]: max_abs_err "
                     f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}) kernel "
                     f"{r['ms']:.4f} ms{dev}, plain {r['plain_ms']:.4f} ms, "
                     f"library {_fmt_ms(r['library_ms'])}, bound "
                     f"{r['bound_ms']:.4f} ms ({r['bound_by']})"
                     + (_fmt_teeth(r) if "err_over_tol" in r else "")
                     + ("" if r["ok"] else "  FAILED"))
            if not r["ok"]:
                bad.append(f"{name}[{r['variant']}]")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")


def phase_kernels():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd, bwd = check_multihot(gen, dev)
    rows = {"segment_add": check_segment_add(gen, dev),
            "multihot_fwd": fwd, "multihot_bwd": bwd,
            "chamfer_min_dist": check_chamfer(gen, dev),
            "graph_if": check_graph_if(gen, dev)}
    report_kernels(rows)
    return rows


def _keep(t):
    """A copy of ``t`` with its strides."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def capture_step_inputs(tr, patch=False, distinct=False):
    """The inputs of every hash-grid lookup kernel (forward and gradient)
    and B4 launch of one training step of ``tr`` (with ``distinct``, of
    the first launch of each shape only: a dense step's remat chunks
    launch each kernel at the same shapes 16 times). The wrappers are
    looked up as module attributes at call time
    (``hash_lookup.lookup_fwd_cuda`` / ``lookup_bwd_cuda``,
    ``multihot._MultihotSample.backward``), so wrapping the attributes for
    one step records each call's inputs (copies, with their strides) and
    restoring them leaves the port as it was."""
    from nvsf_torch.ops import hash_lookup as hl
    calls = {"hash_encode_fwd": [], "hash_encode_bwd": [],
             "multihot_bwd": []}
    seen = set()
    orig_lf, orig_lb = hl.lookup_fwd_cuda, hl.lookup_bwd_cuda
    orig_mb = mh.multihot_bwd_cuda

    def new(key):
        if distinct and key in seen:
            return False
        seen.add(key)
        return True

    def keep_queries(queries):
        return [q._replace(x=_keep(q.x)) for q in queries]

    def lf(reads, queries, resolutions):
        if new(("lf", tuple(tuple(r.shape) for r in reads),
                tuple((tuple(q.x.shape), q.planes) for q in queries))):
            calls["hash_encode_fwd"].append(
                ([_keep(r) for r in reads], keep_queries(queries),
                 tuple(resolutions)))
        return orig_lf(reads, queries, resolutions)

    def lb(queries, grads, resolutions, S, F, precision, features_major,
           device):
        if new(("lb", S, F, precision,
                tuple((tuple(q.x.shape), q.planes) for q in queries))):
            calls["hash_encode_bwd"].append(
                (keep_queries(queries), [_keep(g) for g in grads],
                 tuple(resolutions), S, F, precision, features_major))
        return orig_lb(queries, grads, resolutions, S, F, precision,
                       features_major, device)

    def mb(tables, cols, ws, g, W, need_dw):
        if new(("mb", tuple(cols.shape), W, need_dw)):
            calls["multihot_bwd"].append(
                (*(_keep(t) for t in (tables, cols, ws, g)), W, need_dw))
        return orig_mb(tables, cols, ws, g, W, need_dw)

    hl.lookup_fwd_cuda, hl.lookup_bwd_cuda, mh.multihot_bwd_cuda = \
        lf, lb, mb
    try:
        tr.train_step(0, patch)
        torch.cuda.synchronize()
    finally:
        hl.lookup_fwd_cuda, hl.lookup_bwd_cuda, mh.multihot_bwd_cuda = \
            orig_lf, orig_lb, orig_mb
    return calls


def phase_step_kernels(tr, label="step", distinct=False):
    """Phase 3's "step" rows: the hash-grid lookup's forward and gradient
    and B4 (and B3's forward on B4's inputs, for comparison) on the
    inputs of one LiDAR + camera step of phase 4's trainer, ray-ordered
    samples and all, each against its plain version and timed beside its
    bound; its "uniform" rows (``distinct``) on the first launch of each
    shape of one dense step of phase 8's trainer: one remat chunk's."""
    calls = capture_step_inputs(tr, distinct=distinct)
    rows = {"hash_encode_fwd": [], "hash_encode_bwd": [],
            "multihot_fwd": [], "multihot_bwd": []}
    for i, (reads, queries, res) in enumerate(calls["hash_encode_fwd"]):
        rows["hash_encode_fwd"].append(hash_fwd_row(
            f"{label} #{i} {_lookup_desc(queries, res, reads[0].shape)}",
            reads, queries, res))
        torch.cuda.empty_cache()
    for i, (queries, grads, res, S, F, prec, fm) in enumerate(
            calls["hash_encode_bwd"]):
        rows["hash_encode_bwd"].append(hash_bwd_row(
            f"{label} #{i} {_lookup_desc(queries, res, (S, F))} {prec}",
            queries, grads, res, S, F, prec, fm))
        torch.cuda.empty_cache()
    for i, (tables, cols, ws, g, W, need_dw) in enumerate(
            calls["multihot_bwd"]):
        Q, S, C, Np = cols.shape
        fwd, bwd = multihot_rows(
            f"{label} #{i} Q={Q} S={S} C={C} W={W} F={tables.shape[0]} "
            f"Np={Np}",
            tables, cols, ws, g, W, need_dw)
        rows["multihot_fwd"].append(fwd)
        rows["multihot_bwd"].append(bwd)
    report_kernels(rows)
    return rows


# ----------------------------------------------------------------------
# phase 4: the joint training step at full width
# ----------------------------------------------------------------------

def joint_tuned_config(spec):
    """bench.py's "joint-tuned" rung: 2048 LiDAR + 2048 camera rays, 768
    candidates compacted to K = 96 (LiDAR) / 128 (camera), flow and URF
    losses, bf16 compute, the shipped encoder widths of
    configs/kitti360_1908.txt; eval renders as bench.py's render rung does
    (K' = 96 of 768 for LiDAR, 128 for the camera, early-exit chunks of
    2048 rays, slabs of 16 samples)."""
    s = spec.scale
    return NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=spec.num_frames,
        scale=s, bound=1.0, min_near_lidar=1.0 * s,
        lidar_max_depth=80.0 * s, min_near=1.0 * s, active_sensor=True,
        num_rays=2048, num_rays_lidar=2048, num_steps=768,
        max_ray_batch=2048, num_steps_occ_render=96, stream_slab=16,
        iters=1000, epochs=1, use_error_map=True,
        fp16=True, remat_chunks=1, render_mode="occupancy",
        occ_update_fraction=16, num_steps_occ=96, num_steps_occ_rgb=128,
        flow_loss=True, use_urf_loss=True, n_levels_hash=4,
        n_features_per_level_hash=8, flow_n_levels=4,
        flow_n_features_per_level=32, encoder_remat=False))


def slice_spec():
    """bench.py's synthetic scene: 16 frames, LiDAR 66x1030, camera
    94x352, scale 1/81."""
    from nvsf_torch.data.synthetic import SyntheticSceneSpec
    return SyntheticSceneSpec(num_frames=16, H_lidar=66, W_lidar=1030,
                              H=94, W=352, max_depth=80.0, scale=1.0 / 81.0)


def slice_scene():
    from nvsf_torch.data.synthetic import make_synthetic_scene
    spec = slice_spec()
    return spec, make_synthetic_scene(spec, split="train")


def _time_steps(tr, patch, n=8, warmup=2, graphed=False):
    """Medians over ``n`` steps of (wall ms of the synchronised step, host
    ms until the step returns), eager (``train_step``) or, with
    ``graphed``, the scanned epoch's step (``scan_step``: replays of the
    captured step). The step never synchronises with the card, so the
    second is the host's dispatch of its kernels; when it is close to the
    first, the host bounds the step."""
    step = tr.scan_step if graphed else tr.train_step
    wall, host = [], []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(i % len(tr.scene), patch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert np.isfinite(float(m["loss"]))
        if i >= warmup:
            wall.append((t2 - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
    return float(np.median(wall)), float(np.median(host))


def pool_gib(pool) -> float:
    """GiB held by a memory pool (of the captured steps, ``StepGraphs``,
    or of the frame graphs): the segments it owns, which the allocator's
    count of allocated memory leaves out."""
    pool = tuple(pool)
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == pool) / 2**30


def _relu_gates(mlp, gates=None):
    """Make ``mlp`` (an MLP of one field copy) record the ReLU gates of its
    next call into the list ``gates``, or, given ``gates``, apply those
    instead of its own: h * gate in place of relu(h)."""
    record = []

    def forward(self, h, compute_dtype=torch.float32):
        h = h.to(compute_dtype)
        for li, w in enumerate(self):
            h = h @ w.to(compute_dtype)
            if li < len(self) - 1:
                if gates is None:
                    record.append(h > 0)
                    h = torch.relu(h)
                else:
                    h = h * gates[li].to(h.device)
        return h

    mlp.forward = types.MethodType(forward, mlp)
    return record


def _replay_flow(flow, values=None):
    """Make ``flow`` (the flow field of one field copy) record the output
    of its next call into the returned list and, given ``values`` (the
    CPU's), return those with its own output's gradient: the warped
    positions then fall in the CPU's grid cells. A last-bit difference in
    the flow can move a warped point across a cell boundary, where the
    slope of the interpolation, and so the flow field's gradient, jumps.
    The recorded output is the card's own, which the caller holds to the
    CPU's."""
    record = []
    orig = flow.forward

    def forward(self, *args, **kwargs):
        out = orig(*args, **kwargs)
        record.append(out.detach())
        if values is None:
            return out
        return out + (values[0].to(out.device) - out).detach()

    flow.forward = types.MethodType(forward, flow)
    return record


def check_against_cpu(field):
    """The trained field's density and its parameter gradients on 4096
    points, on the CPU (through the plain versions) and on the card
    (through the kernels), in f32. Table-gradient updates are summed
    unrounded here: rounding to bf16 turns a last-bit difference between
    the two devices' matmuls into a whole bf16 step (phase 3 checks the
    rounding variant against its plain version on identical inputs). The
    card's MLPs take the CPU's ReLU gates: the devices round the MLPs' f32
    sums in another order, so a pre-activation within that rounding of 0
    can switch gate, and its point's gradient then jumps by a hidden
    unit's share. For the same reason the card's flow field returns the
    CPU's flow values, with its own gradient (``_replay_flow``), once its
    own flow output has been held to the CPU's: within 1e-4 of the
    output's largest magnitude (f32 sums in another order through the
    hash encoding and three matmuls, on the same ReLU gates)."""
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((4096, 3), generator=gen) * 1.6 - 0.8
    c1 = torch.randn(4096, generator=gen)
    c2 = torch.randn((4096, field.spec.geo_feat_dim), generator=gen)
    gates = {}
    flows = None
    results = []
    for dev in ("cpu", "cuda"):
        f = copy.deepcopy(field).to(dev)
        f.table_grad_precision = "f32"
        for name in ("sigma_net", "flow"):
            mlp = f.sigma_net if name == "sigma_net" else f.flow.mlp
            rec = _relu_gates(mlp, gates.get(name))
            gates.setdefault(name, rec)
        rec = _replay_flow(f.flow, flows)
        o = f.density(x.to(dev), 0.4, cal_lidar_color=True)
        if flows is None:
            flows = rec
        else:
            ref = flows[0]
            flow_err = float((rec[0].cpu() - ref).abs().max()
                             / ref.abs().max().clamp_min(1e-12))
            assert flow_err < 1e-4, \
                f"flow forward on the card vs CPU: {flow_err:.3e} of its max"
        ((o["sigma"] * c1.to(dev)).sum()
         + (o["geo_feat"] * c2.to(dev)).sum()).backward()
        results.append((o["sigma"].detach().cpu(),
                        {k: p.grad.detach().cpu() if p.grad is not None
                         else torch.zeros(p.shape)
                         for k, p in f.named_parameters()}))
    (sc, gc), (sg, gg) = results
    err = float(((sg - sc).abs() / sc.abs().clamp_min(1e-6)).max())
    assert err < 1e-3, f"density on the card vs CPU: rel err {err:.3e}"
    rel = {k: float((gg[k] - gc[k]).abs().max())
           / max(float(gc[k].abs().max()), 1e-12) for k in gc}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-3, \
        f"gradients on the card vs CPU: {worst} {rel[worst]:.3e}"
    return flow_err, err, worst, rel[worst]


def _family(kernel_name: str) -> str:
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


def profile_device(fn, n=3, host=True):
    """Device time per call of ``fn(i)`` by kernel family
    (torch.profiler): ({family: ms}, kernels per call). ``host=False``
    records the card's activity only: a dense step's ~110k kernels and
    several times as many host operations took the profiler longer to
    gather than the step itself."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA]
    if host:
        acts.insert(0, ProfilerActivity.CPU)
    with profile(activities=acts) as prof:
        for i in range(n):
            fn(i)
        torch.cuda.synchronize()
    fams, launches = {}, 0
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation):   # e.g. Optimizer.step
            continue
        launches += 1
        f = _family(e.name)
        fams[f] = fams.get(f, 0.0) + e.device_time_total / 1e3 / n
    return fams, launches // n


def phase_slice(smi):
    from nvsf_torch.train.trainer import Trainer
    spec, scene = slice_scene()
    cfg = joint_tuned_config(spec)
    t0 = time.perf_counter()
    tr = Trainer(cfg, scene, seed=0, device="cuda")
    torch.cuda.synchronize()
    log("slice", f"setup {time.perf_counter() - t0:.1f} s; {len(scene)} "
                 f"frames, LiDAR {scene.H_lidar}x{scene.W_lidar}, camera "
                 f"{scene.H}x{scene.W}")
    before = {k: p.detach().clone() for k, p in tr.field.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    stats = []
    for ep in (1, 2):       # epoch 2 is a patch epoch (change_patch_size)
        tr.epoch = ep
        t0 = time.perf_counter()
        st = tr.train_one_epoch()
        torch.cuda.synchronize()
        stats.append(st)
        log("slice", f"epoch {ep} ({'patch' if ep % 2 == 0 else 'random'}):"
                     f" loss {st.loss:.5f} in {time.perf_counter() - t0:.1f} "
                     "s; " + " ".join(f"{k}={v:.4g}" for k, v in
                                      st.parts.items() if k != "loss"))
    launches = kernels.launch_counts()
    log("slice", f"launches {launches}; occupancy refreshes "
                 f"{tr.occ_refresh_count}; peak memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bad = [k for st in stats for k, v in st.parts.items()
           if not np.isfinite(v)]
    assert not bad, f"non-finite losses: {bad}"
    unchanged = [k for k, p in tr.field.named_parameters()
                 if torch.equal(p, before[k])]
    assert not unchanged, f"parameters not updated: {unchanged}"
    assert all(torch.isfinite(p).all() for p in tr.field.parameters())
    assert tr.occ_refresh_count >= 1, "no occupancy refresh ran"
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched by the step: {missing}"

    rays = cfg.num_rays_lidar + cfg.num_rays
    sg = tr.step_graphs
    assert sorted(sg.graphs) == [False, True], "the epochs captured no step"
    log("slice", f"captured steps (use_scan=True): random "
                 f"{sg.capture_s[False]:.2f} s, patch {sg.capture_s[True]:.2f}"
                 f" s to capture; replays {sg.replays}")
    step_ms = {}
    for patch in (False, True):
        kind = "patch" if patch else "random"
        # eager (use_scan=False) and graphed, in turns
        for graphed in (False, True, True, False):
            how = "graphed" if graphed else "eager"
            ms, host_ms = _time_steps(tr, patch, n=6, warmup=1,
                                      graphed=graphed)
            step_ms.setdefault((kind, graphed), []).append(ms)
            log("slice", f"steady-state {kind} step, {how}: {ms:.1f} ms = "
                         f"{rays / ms * 1e3:.0f} rays/s; host returns after "
                         f"{host_ms:.1f} ms ({smi})")
        for graphed in (False, True):
            how = "graphed" if graphed else "eager"
            ms = float(np.median(step_ms[kind, graphed]))
            torch.cuda.reset_peak_memory_stats()
            step = tr.scan_step if graphed else tr.train_step
            fams, per_step = profile_device(
                lambda i: step(i % len(tr.scene), patch))
            busy = sum(fams.values())
            log("profile", f"{kind} step, {how}: {ms:.1f} ms (median of "
                           f"{step_ms[kind, graphed]}); device time "
                           f"{busy:.1f} ms in {per_step} kernels; busy "
                           f"share {busy / ms:.2f} of the unprofiled step; "
                           f"peak memory allocated "
                           f"{torch.cuda.max_memory_allocated() / 2**30:.2f}"
                           f" GiB" + (f", the graphs' pool "
                                      f"{pool_gib(sg.pool):.2f} GiB"
                                      if graphed else ""))
            for f, fms in sorted(fams.items(), key=lambda kv: -kv[1]):
                log("profile", f"  {kind} {how} {f:22s} {fms:8.2f} ms/step")
    flow_err, err, worst, gerr = check_against_cpu(tr.field)
    log("slice", f"trained field on the card vs the CPU plain path, the "
                 f"card on the CPU's ReLU gates: flow output {flow_err:.2e} "
                 f"of its max (tol 1e-4), density rel err {err:.2e}, worst "
                 f"gradient {worst} {gerr:.2e} of its max (tol 1e-3)")
    return tr, launches, float(np.median(step_ms["random", False]))


# ----------------------------------------------------------------------
# phase 5: the eval path on phase 4's field
# ----------------------------------------------------------------------

EVAL_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_eval"


def settle_for_render(tr, epochs=4, frames=8, refreshes=18):
    """bench.py's render rung (bench.py:180-188): a few more epochs for
    real surfaces, then whole-grid occupancy refreshes until empty space
    has decayed below the threshold (init 32, decay 0.8: ~16 refreshes),
    so that compaction culls it and the early exit fires."""
    for _ in range(epochs):
        tr.epoch += 1
        tr.train_one_epoch(order=np.arange(frames))
    occ = tr.occ
    tr.occ = dataclasses.replace(occ, update_fraction=1)    # whole grids
    for i in range(refreshes):
        tr.refresh_occupancy(0xACC0 + i)
    tr.occ = occ
    torch.cuda.synchronize()


def check_chamfer_on_frame(tr, pred):
    """B5 against its plain version on the kind of clouds the PointsMeter
    compares: ``pred``, this field's render of training frame 0, thresholded
    by its raydrop as evaluate does, and the frame's ground truth, both in
    metres."""
    from nvsf_torch.lib import convert
    cfg, scene = tr.cfg, tr.scene
    rd = pred["raydrop"]
    if cfg.raydrop_loss == "bce":
        rd = 1.0 / (1.0 + np.exp(-rd))
    gt = scene.images_lidar[0]
    clouds = [torch.as_tensor(convert.pano_to_lidar(
        d / cfg.scale, scene.intrinsics_lidar, scene.intrinsics_hoz_lidar),
        dtype=torch.float32, device=tr.device)
        for d in (pred["depth"] * (rd > cfg.raydrop_thres), gt[:, :, 2]
                  * gt[:, :, 0])]
    st = b5_stats(*b5_compare(*clouds))
    assert st["ok"], f"B5 against its plain version on frame 0: {st}"
    return st, [c.shape[0] for c in clouds]


def check_ema_render(tr):
    """One LiDAR frame rendered from the EMA parameters (evaluate's
    default): finite, through B3, and leaving the trained parameters, the
    EMA and the optimizer's state as they were."""
    def snapshot():
        return [t.detach().clone() for t in (
            *tr.field.parameters(), *tr.ema_field.parameters(),
            *(v for s in tr.optimizer.state.values() for v in s.values()
              if torch.is_tensor(v)))]
    before = snapshot()
    kernels.reset_launch_counts()
    out = tr.render_lidar_frame(0, use_ema=True)
    launches = kernels.launch_counts()
    bad = [k for k, v in out.items() if not np.isfinite(v).all()]
    assert not bad, f"non-finite EMA render: {bad}"
    after = snapshot()
    assert len(after) == len(before) and all(
        torch.equal(x, y) for x, y in zip(before, after)), \
        "the EMA render changed the trained parameters, the EMA or the " \
        "optimizer's state"
    assert launches["multihot_fwd"] > 0, launches
    return launches, float(np.mean(out["depth"])) / tr.cfg.scale


def _frame_rays(tr, stride):
    """Every ``stride``-th ray of training frame 0's LiDAR pano, on the
    CPU: (rays_o, rays_d, t)."""
    from nvsf_torch.lib import rays as raylib
    scene = tr.scene
    Hl, Wl = scene.H_lidar, scene.W_lidar
    inds = torch.arange(0, Hl * Wl, stride, dtype=torch.int32)
    ro, rd = raylib.get_lidar_rays(
        torch.as_tensor(scene.poses_lidar[0]), inds, Hl, Wl,
        scene.intrinsics_lidar, scene.intrinsics_hoz_lidar)
    return ro, rd, float(scene.times[0])


def profile_render(tr, stride=8):
    """Device time by kernel family of a render of every 8th ray of the
    frame (a whole frame is ~10^6 profiler events), a replay of the frame
    graphs (the first call captures them), and its unprofiled wall time:
    ({family: ms}, kernels, wall ms, rays)."""
    ro, rd, t = _frame_rays(tr, stride)
    dev = tr.device
    ro, rd, t = ro.to(dev), rd.to(dev), torch.tensor(t, device=dev)
    kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True)

    def render(_i=0):
        return tr.renderer.render(ro, rd, t, cal_lidar_color=True,
                                  **kw)["depth_lidar"].cpu()

    render()
    t0 = time.perf_counter()
    render()
    wall = (time.perf_counter() - t0) * 1e3
    fams, launches = profile_device(render, n=1)
    return fams, launches, wall, ro.shape[0]


def _render_card_vs_cpu(tr, n, render, what):
    """``n`` LiDAR rays of frame 0, spread over every row of the pano,
    through ``render(renderer, rays_o, rays_d, t)`` with the trained field
    on the card (the kernels) and on the CPU (plain versions), both in f32
    from the same rays. Tolerance 1e-3 of the LiDAR range in depth and 1e-3
    in the heads' outputs."""
    scene = tr.scene
    ro, rd, t = _frame_rays(tr, max(scene.H_lidar * scene.W_lidar // n, 1))
    ro, rd = ro[:n], rd[:n]
    outs = []
    for dev in ("cuda", "cpu"):
        rend = dataclasses.replace(tr.renderer,
                                   field=copy.deepcopy(tr.field).to(dev),
                                   compute_dtype=torch.float32)
        with torch.no_grad():
            o = render(rend, ro.to(dev), rd.to(dev),
                       torch.tensor(t, device=dev))
        outs.append({k: v.cpu() for k, v in o.items()})
    card, cpu = outs
    d_err = float((card["depth_lidar"] - cpu["depth_lidar"]).abs().max())
    i_err = float((card["image_lidar"] - cpu["image_lidar"]).abs().max())
    d_tol = 1e-3 * tr.cfg.lidar_max_depth
    assert d_err <= d_tol and i_err <= 1e-3, \
        f"{what} card vs CPU: depth {d_err:.3e} (tol {d_tol:.3e}), " \
        f"image {i_err:.3e} (tol 1e-3)"
    return d_err, d_tol, i_err


def check_stream_against_cpu(tr, n=4096):
    """The streaming marcher on the card and on the CPU, from the same rays
    and grid (``_render_card_vs_cpu``): the two differ only by the order of
    f32 sums (~1e-6 relative), and where that moves a chunk's early exit by
    one slab, by the weight left behind it, at most trans_eps = 1e-4 of a
    ray."""
    kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True)

    def render(rend, ro, rd, t):
        return rend.run_occupancy_stream(
            ro, rd, t, kw["occ"], kw["occ_grid"].to(ro.device),
            num_steps_occ=kw["num_steps_occ"], cal_lidar_color=True,
            occ_thresh=kw["occ_thresh"], slab=tr.renderer.stream_slab)

    return _render_card_vs_cpu(tr, n, render, "stream render")


def capture_eval_inputs(tr, n_rays=2048):
    """The inputs of B3's launches in the first slab of one render chunk:
    ``n_rays`` LiDAR rays spread over training frame 0 through the
    streaming marcher, eagerly, whose slabs of 16 samples give each segment
    n_rays x 16 samples (the static planes, Q 1 x S 6, and the dynamic
    ones at the three times of the warp, Q 3 x S 12). The forward's wrapper
    is looked up as a module attribute at call time
    (``multihot._MultihotSample.forward``), so wrapping it for one render
    records a copy of the first call of each shape; restoring it leaves
    the port as it was."""
    scene = tr.scene
    ro, rd, t = _frame_rays(tr, scene.H_lidar * scene.W_lidar // n_rays)
    dev = tr.device
    kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True)
    calls = []
    orig = mh.multihot_fwd_cuda

    def fwd(tables, cols, ws, W):
        if all(c[1].shape != cols.shape or c[3] != W for c in calls):
            calls.append((_keep(tables), _keep(cols), _keep(ws), W))
        return orig(tables, cols, ws, W)

    mh.multihot_fwd_cuda = fwd
    try:
        # eagerly (every slab gated on the device): a capture's tensors
        # hold no values
        tr.renderer.stream_batch(
            ro[:n_rays].to(dev), rd[:n_rays].to(dev),
            torch.tensor(t, device=dev), kw["occ"], kw["occ_grid"],
            num_steps_occ=kw["num_steps_occ"], cal_lidar_color=True,
            bg_color=None, occ_thresh=kw["occ_thresh"],
            slab=tr.renderer.stream_slab, trans_eps=1e-4, skip_warp=False)
        torch.cuda.synchronize()
    finally:
        mh.multihot_fwd_cuda = orig
    return calls


def phase_eval_kernels(tr):
    """Phase 3's "eval" rows: B3 on the inputs of one render slab of phase
    5's field, each against its plain version and timed beside its bound
    and embedding_bag."""
    rows = {"multihot_fwd": []}
    for tables, cols, ws, W in capture_eval_inputs(tr):
        Q, S, C, Np = cols.shape
        rows["multihot_fwd"].append(multihot_fwd_row(
            f"eval slab Q={Q} S={S} C={C} W={W} F={tables.shape[0]} "
            f"Np={Np}", tables, cols, ws, W))
    assert len(rows["multihot_fwd"]) == 2, "expected the static and the " \
        "dynamic planes' B3 launch in a render slab"
    report_kernels(rows)
    return rows


def phase_eval(tr, smi):
    from nvsf_torch.data.synthetic import make_synthetic_scene
    from nvsf_torch.train.evaluate import evaluate
    t0 = time.perf_counter()
    settle_for_render(tr)
    log("eval", f"4 more epochs of 8 frames and 18 whole-grid occupancy "
                f"refreshes in {time.perf_counter() - t0:.1f} s")
    val = make_synthetic_scene(slice_spec(), split="val")
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    checks0 = tr.renderer.slab_checks
    slabs = tr.renderer.slab_counter(tr.device)
    slabs.zero_()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    # the trained parameters, not their EMA: the EMA is taken once per
    # epoch at decay 0.95, so after 8 epochs it is still 0.95^8 = 66 % the
    # random init (evaluate's EMA path is held to nvsf_tpu's on the CPU;
    # check_ema_render below runs it on the card)
    res = evaluate(tr, val, use_ema=False, save_dir=str(EVAL_DIR),
                   write_outputs=False,
                   log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log("eval", f"evaluate: {secs:.2f} s for one LiDAR frame "
                f"({val.H_lidar}x{val.W_lidar}) and one camera frame "
                f"({val.H}x{val.W}), each a replay of the frame graphs "
                f"(captured here); launches {launches}; slab checks "
                f"(host syncs) {tr.renderer.slab_checks - checks0}, slabs "
                f"run {int(slabs)}; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    assert tr.renderer.slab_checks == checks0, "a host read between slabs"
    for cat, r in res.items():
        key = {"CD": r["point"][0], "F-score": r["point"][1],
               "depth RMSE": r["depth"][0], "PSNR": r["rgb_psnr"]}
        bad = [k for k, v in key.items() if not np.isfinite(v)]
        assert not bad, f"non-finite {bad} in category {cat}: {r}"
        log("eval", f"{cat}: " + ", ".join(f"{k} {v:.4f}"
                                           for k, v in key.items()))
    missing = [c for c in res
               if not (EVAL_DIR / f"eval_error_matrix_{c}.json").exists()]
    assert not missing, f"error matrices not written: {missing}"
    assert launches["chamfer_min_dist"] >= 2 * len(res), launches
    assert launches["multihot_fwd"] > 0, launches

    # evaluate rendered (and captured) a frame of this size just before
    rays = tr.scene.H_lidar * tr.scene.W_lidar
    times = []
    slabs.zero_()
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = tr.render_lidar_frame(0)             # ends in a host copy
        times.append(time.perf_counter() - t0)
    best = min(times)
    every = ", ".join(f"{t * 1e3:.1f}" for t in times)
    log("eval", f"LiDAR frame render, graphed (occupancy stream, K' 96 of "
                f"768, chunks of 2048): best of {len(times)} "
                f"{best * 1e3:.1f} ms = {rays / best:.0f} rays/s (all: "
                f"{every} ms); {int(slabs) / len(times):.0f} slabs run and "
                f"{tr.renderer.slab_checks - checks0} slab checks per frame "
                f"({smi})")
    fams, n_kernels, wall, n_rays = profile_render(tr)
    busy = sum(fams.values())
    log("profile", f"graphed render of every 8th ray of the frame "
                   f"({n_rays} rays): {wall:.1f} ms, device time "
                   f"{busy:.1f} ms in {n_kernels} kernels; busy share "
                   f"{busy / wall:.2f}")
    for f, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("profile", f"  render {f:22s} {ms:8.2f} ms")
    d_err, d_tol, i_err = check_stream_against_cpu(tr)
    log("eval", f"4096 rays through the stream marcher, card vs CPU in "
                f"f32: depth {d_err:.3e} (tol {d_tol:.3e}), image "
                f"{i_err:.3e} (tol 1e-3)")
    st, (n_pred, n_gt) = check_chamfer_on_frame(tr, pred)
    log("eval", f"B5 vs plain on frame 0's render ({n_pred} points) and its "
                f"ground truth ({n_gt}): max_abs_err {st['max_abs_err']:.3e} "
                f"(tol {st['tol']:.3e})" + _fmt_teeth(st))
    ema_launches, mean_m = check_ema_render(tr)
    log("eval", f"LiDAR frame 0 from the EMA parameters: finite (mean depth "
                f"{mean_m:.3f} m), trained parameters, EMA and optimizer "
                f"state unchanged; launches {ema_launches}")
    return launches, phase_eval_kernels(tr), (rays / best, res)


# ----------------------------------------------------------------------
# phase 13: the frame renders as CUDA graphs against the eager renders
# ----------------------------------------------------------------------

# graphed against eager: the same kernels on the same inputs; an output
# may differ only where a library picks another algorithm inside a capture
FRAME_RTOL = 1e-6


@contextlib.contextmanager
def sync_errors():
    """Inside the block a host synchronisation raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _frame_render(tr, rend, fi, lidar, occ, graphed):
    """Training frame ``fi`` of one sensor through ``rend``: graphed, the
    sweep's render (a replay of the renderer's frame graphs, the rays made
    inside them); else ``Renderer.render_eager`` of the rays the graphs
    make, on the card. Returns (outputs under the renderer's keys, slabs
    run, synchronised wall seconds)."""
    from nvsf_torch.lib import rays as raylib
    from nvsf_torch.render import sweep
    scene, dev = tr.scene, tr.device
    t = float(scene.times[fi])
    if lidar:
        H, W, pose = scene.H_lidar, scene.W_lidar, scene.poses_lidar[fi]
        kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True) if occ else {}
    else:
        H, W, pose = scene.H, scene.W, scene.poses[fi]
        kw = tr._occ_kwargs(tr.occ_grid_rgb) if occ else {}
    rend.slab_counter(dev).zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if graphed and lidar:
        o = sweep.render_pano(rend, pose, t, H, W, scene.intrinsics_lidar,
                              scene.intrinsics_hoz_lidar, kw or None)
        out = {"depth_lidar": o["depth"].reshape(-1),
               "image_lidar": torch.stack([o["raydrop"], o["intensity"]],
                                          -1).reshape(-1, 2)}
    elif graphed:
        o = sweep.render_view(rend, pose, t, H, W, scene.intrinsics,
                              kw or None)
        out = {"depth": o["depth"].reshape(-1),
               "image": o["rgb"].reshape(-1, 3)}
    else:
        pose = torch.as_tensor(pose, dtype=torch.float32, device=dev)
        inds = torch.arange(H * W, dtype=torch.int32, device=dev)
        if lidar:
            ro, rd = raylib.get_lidar_rays(
                pose, inds, H, W, tuple(map(float, scene.intrinsics_lidar)),
                tuple(map(float, scene.intrinsics_hoz_lidar)))
        else:
            ro, rd = raylib.get_camera_rays(pose, inds, H, W, torch.as_tensor(
                scene.intrinsics, dtype=torch.float32, device=dev))
        out = rend.render_eager(ro, rd, torch.tensor(t, device=dev),
                                cal_lidar_color=lidar,
                                bg_color=None if lidar else 1.0, **kw)
    torch.cuda.synchronize()
    return out, int(rend.slabs_run), time.perf_counter() - t0


def _graph_err(got, ref):
    """The worst output's max |graphed - eager| over its max |eager|."""
    return max(float((got[k] - ref[k]).abs().max())
               / max(float(ref[k].abs().max()), 1e-30) for k in ref)


def _stage_name(key) -> str:
    """A frame graph's key as its stage and what it renders."""
    if key[0].endswith("chunk"):
        return f"{key[0]} {'LiDAR' if key[1] else 'camera'}"
    n_rays = key[1][2] if key[0] == "occ-post" else key[2]
    return f"{key[0]} {n_rays} rays"


def phase_render(tr, smi):
    """Phase 13 on phase 5's settled field: every frame render kind,
    graphed against eager; a frame replayed with host syncs made errors; a
    grid written in place read by the next replay; the rates, captures
    and pools. Returns the launches of the phase (the "render" path)."""
    scene = tr.scene
    kernels.reset_launch_counts()
    checks0 = tr.renderer.slab_checks + tr.ema_renderer.slab_checks
    rate, frames = {}, {}
    for name, rend in (("live", tr.renderer), ("EMA", tr.ema_renderer)):
        for lidar in (True, False):
            for occ in (True, False):
                what = (f"{name} {'LiDAR' if lidar else 'camera'} "
                        f"{'occupancy' if occ else 'dense'}")
                rays = (scene.H_lidar * scene.W_lidar if lidar
                        else scene.H * scene.W)
                got, g_slabs, first = _frame_render(tr, rend, 0, lidar, occ,
                                                    True)
                ref, e_slabs, e_s = _frame_render(tr, rend, 0, lidar, occ,
                                                  False)
                err = _graph_err(got, ref)
                assert np.isfinite(err) and err <= FRAME_RTOL, \
                    f"{what}: graphed vs eager {err:.3e}"
                assert g_slabs == e_slabs, (what, g_slabs, e_slabs)
                frames[what] = got
                msg = (f"{what} frame ({rays} rays): graphed vs eager worst "
                       f"{err:.3e} of the output's max (tol {FRAME_RTOL:g})"
                       + (f", slabs run {g_slabs} / {e_slabs}" if occ else "")
                       + f"; first call (captures) {first * 1e3:.1f} ms, "
                       f"eager {e_s * 1e3:.1f} ms = {rays / e_s:.0f} rays/s")
                if name == "live":
                    g_s = min(_frame_render(tr, rend, 0, lidar, occ,
                                            True)[2] for _ in range(2))
                    rate[what] = (rays / g_s, rays / e_s)
                    msg += (f", graphed best of 2 {g_s * 1e3:.1f} ms = "
                            f"{rays / g_s:.0f} rays/s")
                log("render", msg + f" ({smi})")
    assert not torch.equal(frames["live LiDAR occupancy"]["depth_lidar"],
                           frames["EMA LiDAR occupancy"]["depth_lidar"])

    # a whole frame at another pose and time, host syncs made errors
    from nvsf_torch.render import sweep
    rend = tr.renderer
    kw = tr._occ_kwargs(tr.occ_grid_lidar, lidar=True)
    fi = len(scene) - 1
    torch.cuda.synchronize()
    with sync_errors():
        o = sweep.render_pano(rend, scene.poses_lidar[fi], scene.times[fi],
                              scene.H_lidar, scene.W_lidar,
                              scene.intrinsics_lidar,
                              scene.intrinsics_hoz_lidar, kw)
    torch.cuda.synchronize()
    assert torch.isfinite(o["depth"]).all()
    assert not torch.equal(o["depth"].reshape(-1),
                           frames["live LiDAR occupancy"]["depth_lidar"])
    assert tr.renderer.slab_checks + tr.ema_renderer.slab_checks == checks0
    log("render", f"LiDAR frame {fi} (another pose and time) replayed under "
                  f"set_sync_debug_mode('error'): no host sync; slab checks "
                  f"on the card 0")

    # a grid written in place: the next replay reads it
    grid = tr.occ_grid_lidar
    saved = grid.clone()
    with torch.no_grad():
        grid[:, :, grid.shape[2] // 2:] = 0.0
    got, g_slabs, _ = _frame_render(tr, rend, 0, True, True, True)
    ref, e_slabs, _ = _frame_render(tr, rend, 0, True, True, False)
    grid.copy_(saved)
    err = _graph_err(got, ref)
    changed = float((got["depth_lidar"] - frames["live LiDAR occupancy"][
        "depth_lidar"]).abs().max())
    assert err <= FRAME_RTOL and g_slabs == e_slabs and changed > 0, \
        (err, g_slabs, e_slabs, changed)
    log("render", f"upper half of the LiDAR grid emptied in place: the next "
                  f"replay moves depth by up to {changed:.4f}, graphed vs "
                  f"eager {err:.3e}, slabs {g_slabs} / {e_slabs}")

    cfg = tr.cfg
    K = cfg.num_steps_occ_render or cfg.num_steps_occ
    S = min(rend.stream_slab, K)
    n = scene.H_lidar * scene.W_lidar
    Np = -(-n // 8192) * 8192
    chunks = -(-Np // rend.chunk_rays(Np))
    slabs = _frame_render(tr, rend, 0, True, True, True)[1]
    log("render", f"LiDAR frame: {slabs} slabs run of {chunks} x "
                  f"{-(-K // S)} = {chunks * -(-K // S)} without the exit")
    for what, (g, e) in rate.items():
        log("render", f"{what} frame: graphed {g:.0f} rays/s, eager {e:.0f} "
                      f"rays/s ({g / e:.2f}x) ({smi})")
    for name, r in (("live", tr.renderer), ("EMA", tr.ema_renderer)):
        fg = r.frame_graphs
        caps = ", ".join(f"{_stage_name(k)} {s:.2f} s "
                         f"{fg.capture_gib[k]:.3f} GiB"
                         for k, s in fg.capture_s.items())
        log("render", f"{name} renderer: {len(fg.graphs)} graphs, "
                      f"{fg.replays} replays; captures (time, pool growth): "
                      f"{caps}")
    fg = tr.renderer.frame_graphs
    assert fg.pools is tr.ema_renderer.frame_graphs.pools
    graph_gib, body_gib = pool_gib(fg.pools.graph), pool_gib(fg.pools.body.id)
    render_gib = graph_gib + body_gib
    log("render", f"the frame graphs' shared pools: {graph_gib:.3f} GiB + IF "
                  f"bodies {body_gib:.3f} GiB ({smi})")
    launches = kernels.launch_counts()
    log("render", f"launches of the phase {launches}")
    assert launches["multihot_fwd"] > 0 and launches["graph_if"] > 0

    # a replay counts the B3 launches of the slabs that ran, not of the
    # IF nodes the device skipped: per slab as many as the eager frame's
    # per slab step (every step issued there, gated)
    kernels.reset_launch_counts()
    slabs = _frame_render(tr, rend, 0, True, True, True)[1]
    graphed = kernels.launch_counts()
    kernels.reset_launch_counts()
    _frame_render(tr, rend, 0, True, True, False)
    eager = kernels.launch_counts()
    steps = chunks * -(-K // S)
    assert graphed["multihot_fwd"] * steps == eager["multihot_fwd"] * slabs \
        and graphed["graph_if"] == steps, (graphed, eager, slabs, steps)
    log("render", f"LiDAR frame launches: graphed B3 {graphed['multihot_fwd']}"
                  f" for {slabs} slabs run, eager {eager['multihot_fwd']} for "
                  f"{steps} slab steps; IF nodes {graphed['graph_if']}")

    # a training epoch with both renderers' frame graphs resident (as after
    # an evaluate() in training): the card's memory, the eager renders'
    # cached blocks released first
    steps_gib = (pool_gib(tr.step_graphs.pool)
                 if tr.step_graphs is not None else 0.0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.epoch += 1
    tr.train_one_epoch(order=np.arange(8))
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    log("render", f"a training epoch of 8 steps after the renders "
                  f"({time.perf_counter() - t0:.2f} s): peak allocated "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                  f"peak reserved {peak_reserved:.2f} GiB, of which the render pools {render_gib:.2f} GiB and "
                  f"the step graphs' {steps_gib:.2f} GiB; the card's memory "
                  f"in use {(total - free) / 2**30:.2f} of "
                  f"{total / 2**30:.2f} GiB ({smi})")
    return launches


# ----------------------------------------------------------------------
# phase 6: the small convergence drive of the verify notes
# ----------------------------------------------------------------------

def phase_learning(render_mode="occupancy", tag="learning"):
    """The drive in ``render_mode``: 8 epochs of 3 steps, 64 samples a ray
    (occupancy mode keeps 32 of them)."""
    from nvsf_torch.data.synthetic import (SyntheticSceneSpec,
                                           make_synthetic_scene)
    from nvsf_torch.train.trainer import Trainer
    spec = SyntheticSceneSpec(num_frames=4, H_lidar=24, W_lidar=64, H=32,
                              W=40, max_depth=80.0, scale=1.0 / 81.0)
    cfg = NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=4, scale=spec.scale,
        bound=1.0, min_near_lidar=1.0 * spec.scale,
        lidar_max_depth=80.0 * spec.scale, min_near=1.0 * spec.scale,
        active_sensor=True, num_rays=256, num_rays_lidar=256, num_steps=64,
        num_steps_occ=32, render_mode=render_mode, log2_hashmap_size=14,
        n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
        iters=100, epochs=12, use_error_map=True))
    tr = Trainer(cfg, make_synthetic_scene(spec, split="train"),
                 device="cuda")
    losses = [tr.train_one_epoch().loss for _ in range(8)]
    log(tag, f"{render_mode} mode, epoch losses "
             + " ".join(f"{v:.3f}" for v in losses))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < 0.7 * losses[0], \
        f"last loss {losses[-1]:.4f} not below 0.7 x first {losses[0]:.4f}"
    return losses


# ----------------------------------------------------------------------
# phase 7: the shipped config through the port's CLI
# ----------------------------------------------------------------------

REPO = Path(__file__).resolve().parent
CLI_DIR = REPO / "build" / "chip_smoke_cli"
# one eval-mode U-Net forward, card against CPU: sigmoid outputs in [0, 1]
# after ~20 f32 convolutions (TF32 off) summed in another order, ~1e-6
# relative a layer
UNET_TOL = 1e-4


def _ply_faces(path):
    with open(path) as f:
        for line in f:
            if line.startswith("element face"):
                return int(line.split()[2])
    return 0


def _epoch_parts(log_text):
    """{epoch: {"loss": .., part: ..}} of the CLI log's epoch lines."""
    out = {}
    for m in re.finditer(r"\[epoch (\d+)\] loss=(\S+) .*parts=(.*)",
                         log_text):
        parts = {"loss": float(m.group(2))}
        parts.update((k, float(v)) for k, v in
                     (kv.split("=") for kv in m.group(3).split()))
        out[int(m.group(1))] = parts
    return out


def _finite_meters(matrix):
    """Every meter column of an error-matrix JSON but LPIPS (NaN without
    weights: the rgb_lpips meter, slot 2 of depth and intensity)."""
    bad = []
    for k, v in matrix.items():
        if k in ("epoch", "category", "rgb_lpips"):
            continue
        vals = v if isinstance(v, list) else [v]
        for i, x in enumerate(vals):
            if not (k in ("depth", "intensity") and i == 2) \
                    and not np.isfinite(x):
                bad.append(f"{k}[{i}]")
    return bad


def check_unet_against_cpu(tr):
    """One eval-mode forward of the refined run's U-Net on training frame
    0's render, on the card and on a CPU copy of the same weights."""
    pred = tr.render_lidar_frame(0, use_ema=True)
    x = torch.as_tensor(np.stack([pred["raydrop"], pred["intensity"],
                                  pred["depth"]])[None])
    with torch.no_grad():
        card = tr.unet(x.cuda()).cpu()
        cpu = copy.deepcopy(tr.unet).cpu()(x)
    err = float((card - cpu).abs().max())
    assert err <= UNET_TOL, f"U-Net card vs CPU: {err:.3e} (tol {UNET_TOL})"
    return err, tuple(x.shape)


@contextlib.contextmanager
def watch_refine():
    """Inside the block, record each ``RefineSteps`` the refine stage
    makes."""
    import nvsf_torch.train.refine as rf
    orig, seen = rf.RefineSteps, []

    def make(*args, **kwargs):
        seen.append(orig(*args, **kwargs))
        return seen[-1]

    rf.RefineSteps = make
    try:
        yield seen
    finally:
        rf.RefineSteps = orig


def phase_cli(smi):
    from nvsf_torch.lib.image import png_size
    from nvsf_torch.render.export import extract_density_grid
    from nvsf_torch.scripts.main_nvsf import main as cli_main
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    ws, trace = CLI_DIR / "ws", CLI_DIR / "trace"
    common = [
        "--config", str(REPO / "configs" / "kitti360_1908.txt"),
        # no KITTI-360 data on this machine: the synthetic scene, 8 frames
        "--dataloader", "synthetic", "--num_frames", "8",
        # the synthetic LiDAR's vertical FoV, and a far plane past its 25 m
        "--intrinsics_lidar", "10.0", "40.0", "--lidar_max_depth", "30",
        # a short run: 12 epochs of 7 steps (4 epochs leave every ray of the
        # val frame dropped: its CD is NaN and no best checkpoint is
        # written), evals and checkpoints every 4 (patch epochs), 100
        # U-Net refine steps
        "--epochs", "12", "--eval_interval", "4", "--refine_steps", "100",
        # an EMA that follows so short a run (evals, refine renders, test
        # renders and the mesh read the EMA; at 0.95 a 16-epoch EMA is
        # still 44 % the random init and its density stays under 2)
        "--ema_decay", "0.5",
        # this check's outputs
        "--workspace", str(ws)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with watch_refine() as refines:
        tr = cli_main(common + ["--profile_dir", str(trace)])
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    tt = cli_main(common + [
        "--test", "--test_eval", "--use_refine", "--ckpt", "latest",
        # a novel sensor: 1 m higher, 32 beams (+2 extreme rows) over a new
        # vertical FoV, 512 columns
        "--delta_position", "0", "0", "1.0", "--V_lidar_ch", "32",
        "--H_lidar_ch", "512", "--intrinsics_lidar_new", "12.0", "44.0",
        # the mesh window around the synthetic ground and spheres (scaled),
        # and a density threshold inside this short run's range: its
        # densities there stay under 10, the shipped threshold, which is
        # for a trained field
        "--mesh_bound_min", "-0.15", "-0.15", "-0.01",
        "--mesh_bound_max", "0.3", "0.15", "0.04", "--density_thresh", "3"])
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    launches = kernels.launch_counts()
    name = tr.name
    log("cli", f"train run {t_train:.1f} s, test run {t_test:.1f} s; "
                f"launches {launches} ({smi})")
    for run, timers in (("train", tr.timers), ("test", tt.timers)):
        for stage, secs in timers.totals.items():
            log("cli", f"{run} stage {stage:16s} {secs:9.3f} s "
                       f"({timers.counts[stage]}x)")
    unet_ms = tr.timers.totals["refine unet"] / tr.cfg.refine_steps * 1e3
    steps = tr.cfg.refine_steps
    assert [(r.program.warm, r.program.replays) for r in refines] \
        == [(2, steps - 2)], "the refine stage replayed no captured step"
    query = tt.programs[("density query", 65536, True)]
    assert query.replays > 0, "the mesh export replayed no captured query"
    log("cli", f"U-Net refine step {unet_ms:.2f} ms (batch "
               f"{len(tr.scene)} x 3 x {tr.scene.H_lidar} x "
               f"{tr.scene.W_lidar}, {steps} steps: 2 eager, the capture "
               f"{refines[0].program.capture_s:.2f} s, "
               f"{refines[0].program.replays} replays; cuDNN TF32 "
               f"{torch.backends.cudnn.allow_tf32}); mesh export: "
               f"{query.replays} replays of the density query")

    logs = (ws / f"log_{name}.txt").read_text()
    # an epoch retried after running out of memory would pass the checks
    # below on a reloaded checkpoint: the run must not have needed one
    assert "[recovery]" not in logs, "the training run restarted an epoch"
    epochs = _epoch_parts(logs)
    assert sorted(epochs) == [4, 8, 12], f"epochs {sorted(epochs)}"
    for ep, parts in epochs.items():
        bad = [k for k, v in parts.items() if not np.isfinite(v)]
        assert not bad, f"epoch {ep}: non-finite {bad}"
        if ep % tr.cfg.change_patch_size_epoch == 0:     # a patch epoch
            assert parts.get("loss_sr", 0.0) > 0, \
                f"patch epoch {ep} has no loss_sr term: {parts}"
    refine = [float(v) for v in
              re.findall(r"\[refine\] iter \d+ loss (\S+)", logs)]
    assert len(refine) >= 2 and refine[-1] < refine[0], \
        f"refine losses {refine}"
    ckpts = set(p.name for p in (ws / "checkpoints").iterdir())
    need = {f"{name}_ep0012.pkl", f"{name}_best.pkl", f"{name}_refine.pkl"}
    assert need <= ckpts, f"checkpoints {sorted(ckpts)}"
    matrix = json.loads((ws / "validation" / f"{name}_ep0012_refined_"
                         f"error_matrix_combined.json").read_text())
    bad = _finite_meters(matrix)
    assert not bad, f"refined eval: non-finite {bad}: {matrix}"
    res = ws / "results"
    pngs = sorted(res.glob(f"{name}_*_depth.png"))
    assert len(pngs) == len(tt.scene) and tt.has_unet
    sizes = {png_size(p) for p in pngs}
    assert sizes == {(34, 512)}, f"novel-sensor panos {sizes}"
    faces = _ply_faces(res / f"{name}_mesh.ply")
    cfg = tt.cfg
    sigma = extract_density_grid(tt, cfg.mesh_bound_min, cfg.mesh_bound_max,
                                 (64, 64, 16))
    q = np.quantile(sigma, [0.5, 0.9, 0.99, 1.0])
    log("cli", f"EMA density over the mesh window, quantiles 50/90/99/100 "
               f"%: {np.round(q, 3).tolist()}; threshold "
               f"{cfg.density_thresh}")
    assert faces > 0, "the mesh has no faces"
    traces = [p for p in trace.rglob("*") if p.is_file()]
    assert traces, "no device trace written"
    missing = [k for k in TRAIN_KERNELS + ("chamfer_min_dist",)
               if launches[k] == 0]
    assert not missing, f"kernels not launched by the CLI: {missing}"
    log("cli", f"epochs {epochs}; refine losses {refine}; refined eval "
               f"(combined) point {matrix['point']}, depth "
               f"{matrix['depth']}, raydrop {matrix['raydrop']}; "
               f"checkpoints {sorted(ckpts)}; {len(pngs)} novel panos "
               f"34x512; mesh {faces} faces; trace "
               f"{sum(p.stat().st_size for p in traces) / 2**20:.1f} MiB")
    err, shape = check_unet_against_cpu(tr)
    log("cli", f"U-Net eval forward on {shape}, card vs CPU: max abs "
               f"{err:.3e} (tol {UNET_TOL})")
    # ms a step of the last epoch (12, a patch epoch), for phase 11
    return launches, (tr.timers.last["train epoch"] * 1e3
                      / (tr.global_step / tr.epoch))


# ----------------------------------------------------------------------
# phase 8: the dense uniform render mode at full width
# ----------------------------------------------------------------------

UNIFORM_DIR = REPO / "build" / "chip_smoke_uniform"


def uniform_config(spec, **over):
    """Phase 4's config in the dense uniform mode, the JAX package's
    default: all 768 samples of each ray through the field, the density
    query in 8 remat chunks (196,608 samples each, the occupancy step's
    LiDAR N), eval renders in chunks of 4096 rays (the JAX default)."""
    kw = dict(render_mode="uniform", num_steps=768, remat_chunks=8,
              max_ray_batch=4096)
    kw.update(over)
    return dataclasses.replace(joint_tuned_config(spec), **kw)


def check_remat(tr, fi=3):
    """One random step's loss and gradients with the density query in 8
    remat chunks and in one, from the same state and draws (the trainer's
    generator reseeded), in f32 (the lookups' table gradients then sum
    unrounded, B2's semantics). Equal within 1e-5 of each gradient's largest magnitude (the same
    per-point functions; gradients summed over chunks in another order,
    by atomics). Returns the loss, the worst gradient and its error, and
    the peak memory of each (GiB)."""
    rend, field = tr.renderer, tr.field
    saved = (rend.compute_dtype, field.table_grad_precision,
             rend.remat_chunks)
    rend.compute_dtype, field.table_grad_precision = torch.float32, "f32"
    res = {}
    try:
        for chunks in (8, 1):
            rend.remat_chunks = chunks
            tr.generator.manual_seed(1234)
            field.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            loss, _, _ = tr.loss_and_grads(fi, False)
            torch.cuda.synchronize()
            res[chunks] = (float(loss), {
                k: p.grad.detach().clone() for k, p in
                field.named_parameters() if p.grad is not None},
                torch.cuda.max_memory_allocated() / 2**30)
            field.zero_grad(set_to_none=True)
    finally:
        rend.compute_dtype, field.table_grad_precision, \
            rend.remat_chunks = saved
    (l8, g8, m8), (l1, g1, m1) = res[8], res[1]
    assert abs(l8 - l1) <= 1e-5 * abs(l1), f"loss {l8} (8 chunks) vs {l1}"
    assert set(g8) == set(g1), sorted(set(g8) ^ set(g1))
    rel = {k: float((g8[k] - g1[k]).abs().max())
           / max(float(g1[k].abs().max()), 1e-30) for k in g1}
    worst = max(rel, key=rel.get)
    assert rel[worst] <= 1e-5, \
        f"remat 8 vs 1: gradient {worst} {rel[worst]:.3e} of its max"
    return l8, l1, worst, rel[worst], m8, m1


def check_run_against_cpu(tr, n=256):
    """One chunk of ``n`` LiDAR rays x 768 samples through the dense
    ``run`` on the card and on the CPU (``_render_card_vs_cpu``)."""
    def render(rend, ro, rd, t):
        return rend.run(ro, rd, t, cal_lidar_color=True)
    return _render_card_vs_cpu(tr, n, render, "dense run")


def phase_uniform(smi, trained, stream):
    """The dense uniform mode at full width: steps with remat chunks, the
    remat check; then on phase 5's trained field (``trained``, its
    parameters: a few dense steps leave every val ray dropped, and the
    chamfer meters nothing to score) a dense chunk card vs CPU, evaluate
    (dense renders, B5 behind the PointsMeter) beside phase 5's streaming
    eval (``stream``: its rays/s and results) and the LiDAR frame timed;
    and the convergence drive in uniform mode. Returns the launches by
    path (each window's counts set to 0 just before it and read just
    after): "uniform", the full-width steps and the dense eval;
    "uniform-f32", the f32 remat check (B2's only launches; the shipped
    config trains in bf16). The drive's toy-size steps and the card-vs-CPU
    chunk count in neither. Also returns the trainer (for the "uniform"
    kernel rows) and the drive's losses."""
    from nvsf_torch.data.synthetic import make_synthetic_scene
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.trainer import Trainer
    stream_rays_per_s, stream_res = stream
    spec, scene = slice_scene()
    cfg = uniform_config(spec)
    t0 = time.perf_counter()
    tr = Trainer(cfg, scene, seed=0, device="cuda")
    assert tr.occ is None and tr.renderer.remat_chunks == 8
    torch.cuda.synchronize()
    log("uniform", f"setup {time.perf_counter() - t0:.1f} s; "
                   f"{cfg.num_rays_lidar} + {cfg.num_rays} rays x "
                   f"{cfg.num_steps} samples, remat chunks "
                   f"{cfg.remat_chunks}")
    t_phase = time.perf_counter()

    def took():
        return f"[{time.perf_counter() - t_phase:.1f} s into the phase]"

    kernels.reset_launch_counts()
    before = {k: p.detach().clone() for k, p in tr.field.named_parameters()}
    torch.cuda.reset_peak_memory_stats()
    rays = cfg.num_rays_lidar + cfg.num_rays
    for patch in (False, True):
        kind = "patch" if patch else "random"
        ms, host_ms = _time_steps(tr, patch, n=1, warmup=1)
        log("uniform", f"steady-state {kind} step: {ms:.1f} ms = "
                       f"{rays / ms * 1e3:.0f} rays/s; host returns after "
                       f"{host_ms:.1f} ms ({smi}) {took()}")
        if patch:
            continue
        fams, per_step = profile_device(
            lambda i: tr.train_step(i % len(tr.scene), patch), n=1,
            host=False)
        assert per_step > 0, "the profiler recorded no kernel of the step"
        busy = sum(fams.values())
        log("profile", f"uniform {kind} step: device time {busy:.1f} ms in "
                       f"{per_step} kernels; busy share {busy / ms:.2f} of "
                       f"the unprofiled step {took()}")
        for f, fms in sorted(fams.items(), key=lambda kv: -kv[1]):
            log("profile", f"  uniform {kind} {f:22s} {fms:8.2f} ms/step")
    # the captured dense step (use_scan=True): its two eager warm-ups and
    # the capture, then replays
    torch.cuda.reset_peak_memory_stats()
    ms_g, host_g = _time_steps(tr, False, n=2, warmup=WARMUP_STEPS + 1,
                               graphed=True)
    fams, per_step = profile_device(
        lambda i: tr.scan_step(i % len(tr.scene), False), n=1, host=False)
    busy = sum(fams.values())
    log("profile", f"uniform random step, graphed: {ms_g:.1f} ms = "
                   f"{rays / ms_g * 1e3:.0f} rays/s (host returns after "
                   f"{host_g:.1f} ms); device time {busy:.1f} ms in "
                   f"{per_step} kernels; busy share {busy / ms_g:.2f}; "
                   f"capture {tr.step_graphs.capture_s[False]:.2f} s; peak "
                   f"memory allocated "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
                   f"the graph's pool "
                   f"{pool_gib(tr.step_graphs.pool):.2f} GiB ({smi}) "
                   f"{took()}")
    step_launches = kernels.launch_counts()
    log("uniform", f"peak memory of the steps (8 remat chunks) "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
                   f"launches of its {tr.global_step} steps "
                   f"{step_launches}")
    unchanged = [k for k, p in tr.field.named_parameters()
                 if torch.equal(p, before[k])]
    assert not unchanged, f"parameters not updated: {unchanged}"
    assert all(torch.isfinite(p).all() for p in tr.field.parameters())
    del before

    kernels.reset_launch_counts()
    l8, l1, worst, gerr, m8, m1 = check_remat(tr)
    f32_launches = kernels.launch_counts()
    log("uniform", f"remat 8 vs 1 chunks, one f32 step at 2048 + 2048 rays:"
                   f" loss {l8:.7g} / {l1:.7g}, worst gradient {worst} "
                   f"{gerr:.2e} of its max (tol 1e-5); peak memory "
                   f"{m8:.2f} / {m1:.2f} GiB {took()}")
    tr.field.load_state_dict(trained)
    d_err, d_tol, i_err = check_run_against_cpu(tr)
    log("uniform", f"phase 5's field: 256 rays x 768 samples through the "
                   f"dense run, card vs CPU in f32: depth {d_err:.3e} (tol "
                   f"{d_tol:.3e}), image {i_err:.3e} (tol 1e-3) {took()}")

    val = make_synthetic_scene(spec, split="val")
    shutil.rmtree(UNIFORM_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with watch_lidar_sweep() as frame_render:
        res = evaluate(tr, val, use_ema=False, save_dir=str(UNIFORM_DIR),
                       write_outputs=False,
                       log_fn=lambda m: print(m, flush=True))
    torch.cuda.synchronize()
    log("uniform", f"evaluate of phase 5's field, dense renders: "
                   f"{time.perf_counter() - t0:.2f} s; peak memory "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
                   f"{took()}")
    for cat, r in res.items():
        key = {"CD": r["point"][0], "F-score": r["point"][1],
               "depth RMSE": r["depth"][0], "PSNR": r["rgb_psnr"]}
        bad = [k for k, v in key.items() if not np.isfinite(v)]
        assert not bad, f"non-finite {bad} in category {cat}: {r}"
        s = stream_res[cat]
        log("uniform", f"{cat}: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in key.items())
            + f" (phase 5's streaming eval of this field: CD "
              f"{s['point'][0]:.4f}, F-score {s['point'][1]:.4f}, depth "
              f"RMSE {s['depth'][0]:.4f}, PSNR {s['rgb_psnr']:.4f})")
    # the val frame's LiDAR render, timed inside evaluate
    frame = val.H_lidar * val.W_lidar
    secs = frame_render["seconds"]
    chunks = -(-frame // cfg.max_ray_batch)
    log("uniform", f"LiDAR frame render in evaluate (dense, graphed, "
                   f"{frame} rays x {cfg.num_steps} samples in {chunks} "
                   f"chunks of {cfg.max_ray_batch}, captured here): "
                   f"{secs * 1e3:.1f} ms = "
                   f"{frame / secs:.0f} rays/s; the streaming marcher of "
                   f"phase 5: {stream_rays_per_s:.0f} rays/s ({smi})")
    fams, n_kernels, wall, n_rays = profile_render(tr)
    busy = sum(fams.values())
    log("profile", f"graphed dense render of every 8th ray of the frame "
                   f"({n_rays} rays): {wall:.1f} ms, device time "
                   f"{busy:.1f} ms in {n_kernels} kernels; busy share "
                   f"{busy / wall:.2f} "
                   f"{took()}")
    for f, fms in sorted(fams.items(), key=lambda kv: -kv[1]):
        log("profile", f"  dense render {f:22s} {fms:8.2f} ms")
    eval_launches = kernels.launch_counts()
    launches = {k: step_launches[k] + eval_launches[k] for k in step_launches}
    log("uniform", f"launches of the full-width path: steps {step_launches}"
                   f", dense eval {eval_launches}; the f32 remat check "
                   f"{f32_launches} {took()}")
    missing = [k for k in TRAIN_KERNELS + ("chamfer_min_dist",)
               if launches[k] == 0]
    assert not missing, f"kernels not launched by the uniform path: " \
                        f"{missing}"
    assert f32_launches["hash_encode_bwd"] > 0, f32_launches
    losses = phase_learning("uniform", tag="uniform")
    return {"uniform": launches, "uniform-f32": f32_launches}, tr, losses


# ----------------------------------------------------------------------
# phase 9: a raw KITTI-360 tree through the port's preprocessing and CLI
# ----------------------------------------------------------------------

KITTI_DIR = REPO / "build" / "chip_smoke_kitti"
KITTI_REC = "2013_05_28_drive_0000"
# KITTI-360's published calibration of camera 00 and the Velodyne
# (calibration/perspective.txt, calib_cam_to_pose.txt,
# calib_cam_to_velo.txt); P_rect_00 is scaled to the 1/4-size images
KITTI_P_RECT = (552.554261, 682.049453, 238.769549)
KITTI_CAM_TO_POSE = (
    0.0371783278, -0.0986182135, 0.9944306009, 1.5752681039,
    0.9992675562, -0.0053553387, -0.0378902567, 0.0043914093,
    0.0090621821, 0.9951109327, 0.0983468786, -0.6500000000)
KITTI_CAM_TO_VELO = (
    0.04307104361, -0.08829286498, 0.995162929, 0.8043914418,
    -0.999004371, 0.007784614041, 0.04392796942, 0.2993489574,
    -0.01162548558, -0.9960641394, -0.08786966659, -0.1770225824)
# the Velodyne's height over the road, and the street the sweeps see
VELO_HEIGHT = 1.73
WALLS_Y = (9.0, -11.0)          # building fronts left and right
WALL_TOP = 8.0
POLE_SPACING, POLE_Y, POLE_R = 15.0, (6.0, -7.5), 0.3


def hdl64_sweep(car_x, rng, beams=64, columns=1875):
    """One HDL-64E-like sweep in the Velodyne frame: 64 beams from +2 to
    -24.9 degrees, 1875 columns (120,000 returns before drops), each ray
    hitting the road, a building front, a pole or nothing within 80 m;
    3 % random drops, 2 cm range noise. Returns [N, 4] f32 x, y, z,
    intensity."""
    incl = np.radians(np.linspace(2.0, -24.9, beams))[:, None]
    az = np.linspace(-np.pi, np.pi, columns, endpoint=False)[None, :] \
        + rng.uniform(0, 2 * np.pi / columns, (beams, 1))
    d = np.stack(np.broadcast_arrays(np.cos(incl) * np.cos(az),
                                     np.cos(incl) * np.sin(az),
                                     np.sin(incl)), -1).reshape(-1, 3) \
        .astype(np.float32)
    t = np.full(len(d), np.inf, np.float32)
    inten = np.zeros(len(d), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        tg = np.where(d[:, 2] < 0, -VELO_HEIGHT / d[:, 2], np.inf)
        hit = tg < t
        t[hit], inten[hit] = tg[hit], 0.15
        for wy in WALLS_Y:
            tw = np.where(d[:, 1] * wy > 0, wy / d[:, 1], np.inf)
            tw[tw * d[:, 2] > WALL_TOP - VELO_HEIGHT] = np.inf
            hit = tw < t
            t[hit], inten[hit] = tw[hit], 0.45
    k = np.floor((car_x - 80.0) / POLE_SPACING) + np.arange(12)
    c = np.stack(np.broadcast_arrays(k[:, None] * POLE_SPACING - car_x,
                                     np.array(POLE_Y)[None, :]),
                 -1).reshape(-1, 2).astype(np.float32)       # [P, 2]
    a = (d[:, :2] ** 2).sum(-1, keepdims=True)
    b = d[:, :2] @ c.T                                       # [N, P]
    disc = b * b - a * ((c ** 2).sum(-1) - POLE_R ** 2)
    with np.errstate(invalid="ignore", divide="ignore"):
        tp = np.where(disc > 0, (b - np.sqrt(disc)) / a, np.inf)
    tp = np.where(tp > 0, tp, np.inf).min(axis=1)
    hit = tp < t
    t[hit], inten[hit] = tp[hit], 0.8
    keep = (t < 80.0) & (rng.uniform(size=len(d)) > 0.03)
    r = t[keep] + rng.normal(0, 0.02, keep.sum())
    pts = np.column_stack([d[keep] * r[:, None],
                           np.clip(inten[keep] + rng.normal(
                               0, 0.05, keep.sum()), 0, 1)])
    return pts.astype(np.float32)


def write_raw_kitti(src, seq="1908", H=94, W=352, seed=0):
    """A raw KITTI-360 tree of ``seq`` with its real frame ids: the
    calibration, one pose a frame (the car driving 1 m a frame along the
    street), a Velodyne .bin and a camera PNG (1/4 size) a frame, and a 3D
    box XML. Returns the frame ids."""
    from nvsf_torch.lib.tools import write_png
    from nvsf_torch.preprocess.kitti360 import SEQUENCE_SPLITS
    rng = np.random.default_rng(seed)
    s, e, _ = SEQUENCE_SPLITS[seq]
    fids = list(range(s, e + 1))
    calib = src / "calibration"
    calib.mkdir(parents=True)
    f, cx, cy = (v / 4 for v in KITTI_P_RECT)
    P = f"{f} 0 {cx} 0 0 {f} {cy} 0 0 0 1 0"
    R = "1 0 0 0 1 0 0 0 1"
    (calib / "perspective.txt").write_text(
        f"P_rect_00: {P}\nR_rect_00: {R}\nP_rect_01: {P}\nR_rect_01: {R}\n")
    c2p = " ".join(map(str, KITTI_CAM_TO_POSE))
    (calib / "calib_cam_to_pose.txt").write_text(
        "".join(f"image_0{i}: {c2p}\n" for i in range(4)))
    (calib / "calib_cam_to_velo.txt").write_text(
        " ".join(map(str, KITTI_CAM_TO_VELO)) + "\n")
    poses = src / "data_poses" / f"{KITTI_REC}_sync"
    poses.mkdir(parents=True)
    origin = np.array([1063.67, 3765.24, 112.26])
    lines = []
    for i, fid in enumerate(fids):
        T = np.eye(4)
        T[:3, 3] = origin + [1.0 * i, 0.0, 0.0]
        lines.append(" ".join([str(fid)] + [repr(float(v)) for v in
                                            T[:3].reshape(-1)]))
    (poses / "poses.txt").write_text("\n".join(lines) + "\n")
    velo = src / "data_3d_raw" / f"{KITTI_REC}_sync" / "velodyne_points" \
        / "data"
    cams = src / "data_2d_raw" / f"{KITTI_REC}_sync" / "image_00" \
        / "data_rect"
    velo.mkdir(parents=True)
    cams.mkdir(parents=True)
    yy, xx = np.mgrid[0:H, 0:W]
    for i, fid in enumerate(fids):
        hdl64_sweep(float(i), rng).tofile(velo / f"{fid:010d}.bin")
        sky = yy < H * 0.45
        img = np.stack([np.where(sky, 150 + yy, 90 + (xx + 4 * i) % 40),
                        np.where(sky, 180 + yy // 2, 90 + yy // 3),
                        np.where(sky, 230 - yy, 80 + (xx // 8) % 20)], -1)
        img = img + rng.integers(0, 12, img.shape)
        write_png(cams / f"{fid:010d}.png", np.clip(img, 0, 255))
    boxes = src / "data_3d_bboxes" / "train_full"
    boxes.mkdir(parents=True)
    verts = " ".join(str(v) for x in (-2.2, 2.2) for y in (-0.9, 0.9)
                     for z in (-0.75, 0.75) for v in (x, y, z))
    T = np.eye(4)
    T[:3, 3] = origin + [25.0, 4.0, -VELO_HEIGHT + 0.75]
    tdata = " ".join(map(str, T.reshape(-1)))
    (boxes / f"{KITTI_REC}_sync.xml").write_text(
        f"<?xml version=\"1.0\"?>\n<opencv_storage>\n<object_1>\n"
        f"  <label>car</label>\n  <timestamp>-1</timestamp>\n"
        f"  <start_frame>{s}</start_frame>\n  <end_frame>{e}</end_frame>\n"
        f"  <transform><rows>4</rows><cols>4</cols><data>{tdata}</data>"
        f"</transform>\n  <vertices><rows>8</rows><cols>3</cols>"
        f"<data>{verts}</data></vertices>\n</object_1>\n</opencv_storage>\n")
    return fids


def check_rangeviews(src, fids):
    """The native range views against numpy's projection of the same .bin
    files: equal within one f32 rounding of projections that agree to
    1e-9. Returns (frames bit for bit, frames, ms a frame native, ms a
    frame numpy)."""
    from nvsf_torch.lib.convert import lidar_to_pano_with_intensities_numpy
    from nvsf_torch.preprocess import kitti360 as K
    exact, t_native, t_numpy = 0, 0.0, 0.0
    for fid in fids:
        p = K.velodyne_path(src, KITTI_REC, fid)
        t0 = time.perf_counter()
        rv = K.bin_to_rangeview(p)
        t1 = time.perf_counter()
        pano, inten = lidar_to_pano_with_intensities_numpy(
            K.read_velodyne_bin(p), K.KITTI_LIDAR_H, K.KITTI_LIDAR_W,
            K.KITTI_INTRINSICS, K.KITTI_INTRINSICS_HOZ, K.KITTI_MAX_DEPTH)
        t2 = time.perf_counter()
        t_native += t1 - t0
        t_numpy += t2 - t1
        ref = np.stack([np.zeros_like(pano), inten, pano], -1)
        np.testing.assert_allclose(rv, ref, rtol=2**-23, atol=1e-9,
                                   err_msg=f"frame {fid}")
        exact += int(np.array_equal(rv, ref.astype(np.float32)))
    n = len(fids)
    return exact, n, t_native / n * 1e3, t_numpy / n * 1e3


def phase_kitti(smi):
    """Raw KITTI-360 to a trained and scored field on this machine alone:
    a raw tree of sequence 1908 (its 64 real frame ids; Velodyne sweeps of
    ~116k returns; camera PNGs at 1/4 size, 94x352, the one cut: a full
    376x1408 val frame is ~530k rays through the marcher, ~50 s a frame)
    through ``python -m nvsf_torch.scripts.preprocess_data``; the native
    range views held to numpy's on 4 frames; then the CLI on the config
    it wrote at the widths of configs/kitti360_1908.txt (occupancy, K 96 /
    128, 4 x 8 hash, 4 x 32 flow hash, bf16, enable_rgb): 1 epoch of 60
    steps, the EMA following the parameters, no U-Net refine (it renders
    all 60 training frames), then the eval of the 4 val frames. Returns
    the path's launches."""
    from nvsf_torch.config import load_config
    from nvsf_torch.data.kitti360 import load_kitti360_scene
    from nvsf_torch.lib.image import read_png
    from nvsf_torch.scripts.main_nvsf import main as cli_main
    shutil.rmtree(KITTI_DIR, ignore_errors=True)
    data = KITTI_DIR / "kitti360"
    src = data / "source_data"
    t0 = time.perf_counter()
    fids = write_raw_kitti(src)
    log("kitti", f"raw tree of sequence 1908: {len(fids)} frames "
                 f"({fids[0]}-{fids[-1]}) in "
                 f"{time.perf_counter() - t0:.1f} s")
    cmd = [sys.executable, "-m", "nvsf_torch.scripts.preprocess_data",
           "--sequence_name", "1908", "--kitti_root", str(src),
           "--data_root", str(data), "--config_dir",
           str(KITTI_DIR / "configs"), "--workspace", str(KITTI_DIR / "ws")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    secs = time.perf_counter() - t0
    assert proc.returncode == 0, f"{' '.join(cmd)}\n{proc.stdout}" \
                                 f"{proc.stderr}"
    for line in proc.stdout.splitlines():
        log("kitti", line)
    log("kitti", f"preprocess_data: {secs:.2f} s for {len(fids)} frames, "
                 f"the process included ({smi})")
    exact, n, ms_native, ms_numpy = check_rangeviews(src, fids[::16])
    log("kitti", f"range views native vs numpy on {n} frames: within f32 "
                 f"rounding, {exact} of {n} bit for bit; {ms_native:.1f} "
                 f"ms a frame native (read + project), {ms_numpy:.1f} ms "
                 f"numpy")
    sweeps = [len(np.fromfile(src / "data_3d_raw" / f"{KITTI_REC}_sync" /
                              "velodyne_points" / "data" / f"{f:010d}.bin",
                              np.float32)) // 4 for f in fids[:4]]
    cfg_path = KITTI_DIR / "configs" / "kitti360_1908.txt"
    argv = [
        "--config", str(cfg_path),
        # the widths of configs/kitti360_1908.txt that the written scene
        # config leaves at their defaults
        "--active_sensor", "--render_mode", "occupancy",
        "--n_levels_hash", "4", "--n_features_per_level_hash", "8",
        "--flow_n_levels", "4", "--flow_n_features_per_level", "32",
        "--num_steps_occ", "96", "--num_steps_occ_rgb", "128",
        "--num_steps_occ_render", "96",
        # a short run: 1 epoch of 60 steps, the EMA following the
        # parameters, the eval once at the end, no refine
        "--epochs", "1", "--eval_interval", "1", "--ema_decay", "0",
        "--refine_steps", "0", "--workspace", str(KITTI_DIR / "ws")]
    cfg = load_config(argv).finalize(steps_per_epoch=60)
    assert cfg.enable_rgb and cfg.fp16 and cfg.flow_loss, cfg
    pngs = sorted((src / "data_2d_raw").rglob("*.png"))
    t0 = time.perf_counter()
    for p in pngs:
        read_png(p)
    t_png = time.perf_counter() - t0
    t0 = time.perf_counter()
    scene = load_kitti360_scene(cfg, "train")
    t_load = time.perf_counter() - t0
    assert scene.images.shape == (60, 94, 352, 3), scene.images.shape
    assert len(scene.annotations) == 60 and scene.annotations[0]
    log("kitti", f"image load: {len(pngs)} PNGs decoded in "
                 f"{t_png * 1e3:.0f} ms ({t_png / len(pngs) * 1e3:.2f} ms "
                 f"each); the train split (60 frames: panos, images, "
                 f"pseudo-depths, boxes) loaded in {t_load:.2f} s; sweeps "
                 f"of {sweeps} returns")
    del scene
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr = cli_main(argv)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = kernels.launch_counts()
    ws = KITTI_DIR / "ws"
    logs = (ws / f"log_{tr.name}.txt").read_text()
    assert "[recovery]" not in logs, "the training run restarted an epoch"
    epochs = _epoch_parts(logs)
    assert sorted(epochs) == [1], f"epochs {sorted(epochs)}"
    bad = [k for k, v in epochs[1].items() if not np.isfinite(v)]
    assert not bad, f"non-finite losses {bad}"
    for stage, secs in tr.timers.totals.items():
        log("kitti", f"stage {stage:16s} {secs:9.3f} s "
                     f"({tr.timers.counts[stage]}x)")
    scores = {}
    for cat in ("combined", "static", "dynamic"):
        path = ws / "validation" / f"{tr.name}_ep0001_error_matrix_{cat}.json"
        if path.exists():
            m = json.loads(path.read_text())
            scores[cat] = {"CD": m["point"][0], "F-score": m["point"][1],
                           "PSNR": m["rgb_psnr"]}
    key = scores["combined"]
    bad = [k for k, v in key.items() if not np.isfinite(v)]
    assert not bad, f"non-finite {bad} in the val eval: {scores}"
    missing = [k for k in TRAIN_KERNELS + ("chamfer_min_dist",)
               if launches[k] == 0]
    assert not missing, f"kernels not launched by the KITTI path: {missing}"
    log("kitti", f"CLI run {t_run:.1f} s ({tr.global_step} steps, then "
                 f"the eval of the 4 val frames at 66x1030 and 94x352); "
                 f"val eval {scores}; epoch 1 parts {epochs[1]}; launches "
                 f"{launches} ({smi})")
    return launches


# ----------------------------------------------------------------------
# phase 10: the joint_fusion step against the separate step
# ----------------------------------------------------------------------

def joint_8x4_config(spec, **over):
    """bench.py's "joint-8x4" rung (bench.py:64-66) on phase 4's scene:
    2048 + 2048 rays, 768 candidates compacted to K = 128 for both
    branches, the reference's encoder widths (hash 8 x 4, flow hash
    16 x 8), flow and URF losses, bf16."""
    kw = dict(num_steps_occ=128, num_steps_occ_rgb=128, n_levels_hash=8,
              n_features_per_level_hash=4, flow_n_levels=16,
              flow_n_features_per_level=8)
    kw.update(over)
    return dataclasses.replace(joint_tuned_config(spec), **kw)


def _render_draws(cfg, gen):
    """The z-noise and jitter draws of one step's two renders."""
    return {f"{b}_render": {
        "z_noise": torch.rand((n, cfg.num_steps), generator=gen,
                              device=gen.device),
        "jitter_u": torch.rand((n, cfg.num_steps_occ), generator=gen,
                               device=gen.device)}
        for b, n in (("lidar", cfg.num_rays_lidar), ("rgb", cfg.num_rays))}


def joint_vs_separate(tr, fi=3, f32=False, seed=0):
    """One step's loss and gradients through the fused path and through
    the separate one, from the same state and draws (the sampler's
    generator reseeded, the render draws given, both from ``seed``); with
    ``f32`` in f32 (the table gradients then sum unrounded). Returns the two
    losses, the worst gradient and its error over the gradient's largest
    magnitude."""
    rend, field = tr.renderer, tr.field
    saved = (rend.compute_dtype, field.table_grad_precision, tr.joint)
    if f32:
        rend.compute_dtype, field.table_grad_precision = torch.float32, "f32"
    out = {}
    try:
        for joint in (True, False):
            tr.joint = joint
            tr.generator.manual_seed(4321 + seed)
            draws = _render_draws(tr.cfg, torch.Generator(tr.device)
                                  .manual_seed(8765 + seed))
            field.zero_grad(set_to_none=True)
            loss, _, _ = tr.loss_and_grads(fi, False, draws)
            out[joint] = (float(loss), {
                k: p.grad.detach().clone() for k, p in
                field.named_parameters() if p.grad is not None})
            field.zero_grad(set_to_none=True)
    finally:
        rend.compute_dtype, field.table_grad_precision, tr.joint = saved
    (lj, gj), (ls, gs) = out[True], out[False]
    assert set(gj) == set(gs), sorted(set(gj) ^ set(gs))
    rel = {k: float((gj[k] - gs[k]).abs().max())
           / max(float(gs[k].abs().max()), 1e-30) for k in gs}
    worst = max(rel, key=rel.get)
    return lj, ls, worst, rel[worst]


# bf16 step losses, fused against separate, at JOINT_BF16_SEEDS states and
# draws: the same per-sample functions, but the sigma net's bf16 matmuls
# run on another batch size, which may take another kernel that sums in
# another order. On the H100 the two losses came out bit-equal at every
# seed (PERF.md section 6); the tolerance is ~8 f32 ulps of the loss
JOINT_BF16_RTOL = 1e-6
JOINT_BF16_SEEDS = 4


def phase_joint(smi):
    """The joint_fusion step against the separate step at full width, on
    one trainer (``Trainer.joint`` switched between them): one fused epoch
    (the "joint" launches), the two paths' equivalence in bf16 (at
    JOINT_BF16_SEEDS states and draws) and in f32, then each step timed in
    turns (separate, fused, fused, separate; median of 4 after 1 warm-up
    steps each), profiled, and its peak memory.
    Returns the launches and the trainer."""
    from nvsf_torch.train.trainer import Trainer
    spec, scene = slice_scene()
    cfg = joint_8x4_config(spec, joint_fusion=True)
    t0 = time.perf_counter()
    tr = Trainer(cfg, scene, seed=0, device="cuda")
    assert tr.joint
    kernels.reset_launch_counts()
    tr.epoch = 1
    st = tr.train_one_epoch()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log("joint", f"joint-8x4 (hash 8x4, flow 16x8, K 128 / 128, "
                 f"{cfg.num_rays_lidar} + {cfg.num_rays} rays, bf16): setup "
                 f"and one fused epoch of {len(scene)} steps "
                 f"{time.perf_counter() - t0:.1f} s, loss {st.loss:.5f}; "
                 f"launches {launches}")
    bad = [k for k, v in st.parts.items() if not np.isfinite(v)]
    assert not bad, f"non-finite losses: {bad}"
    missing = [k for k in TRAIN_KERNELS if launches[k] == 0]
    assert not missing, f"kernels not launched by the fused step: {missing}"
    gaps = []
    for seed in range(JOINT_BF16_SEEDS):
        fi = (3 + 4 * seed) % len(scene)
        lj, ls, worst, err = joint_vs_separate(tr, fi, seed=seed)
        gaps.append(abs(lj - ls) / abs(ls))
        log("joint", f"bf16 step {fi} from one state and draws (seed "
                     f"{seed}): loss fused {lj!r} separate {ls!r}, gap "
                     f"{gaps[-1]:.3e} of it; worst gradient {worst} "
                     f"{err:.2e} of its max")
    assert max(gaps) <= JOINT_BF16_RTOL, (gaps, JOINT_BF16_RTOL)
    log("joint", f"bf16 loss gaps over {JOINT_BF16_SEEDS} seeds: largest "
                 f"{max(gaps):.3e} (rtol {JOINT_BF16_RTOL})")
    lj, ls, worst, err = joint_vs_separate(tr, f32=True)
    assert abs(lj - ls) <= 1e-5 * abs(ls), (lj, ls)
    assert err <= 1e-5, f"fused vs separate: gradient {worst} {err:.3e}"
    log("joint", f"f32 step: loss fused {lj:.7g} separate {ls:.7g}; worst "
                 f"gradient {worst} {err:.2e} of its max (tol 1e-5)")
    rays = cfg.num_rays_lidar + cfg.num_rays
    times, mem = {True: [], False: []}, {}
    for joint in (False, True, True, False):
        tr.joint = joint
        torch.cuda.reset_peak_memory_stats()
        ms, host_ms = _time_steps(tr, False, n=4, warmup=1)
        times[joint].append(ms)
        mem[joint] = max(mem.get(joint, 0.0),
                         torch.cuda.max_memory_allocated() / 2**30)
        log("joint", f"{'fused' if joint else 'separate'} step: {ms:.1f} ms"
                     f" = {rays / ms * 1e3:.0f} rays/s; host returns after "
                     f"{host_ms:.1f} ms")
    # the fused step as the scanned epoch runs it: replays of the step the
    # fused epoch captured
    tr.joint = True
    torch.cuda.reset_peak_memory_stats()
    ms_g, host_g = _time_steps(tr, False, n=4, warmup=1, graphed=True)
    fams, per_step = profile_device(
        lambda i: tr.scan_step(i % len(tr.scene), False), n=2)
    busy = sum(fams.values())
    log("joint", f"fused step, graphed: {ms_g:.1f} ms = "
                 f"{rays / ms_g * 1e3:.0f} rays/s (host returns after "
                 f"{host_g:.1f} ms); device time {busy:.1f} ms in "
                 f"{per_step} kernels; busy share {busy / ms_g:.2f}; capture "
                 f"{tr.step_graphs.capture_s[False]:.2f} s; peak memory "
                 f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} "
                 f"GiB, the graph's pool "
                 f"{pool_gib(tr.step_graphs.pool):.2f} GiB ({smi})")
    for joint in (False, True):
        tr.joint = joint
        name = "fused" if joint else "separate"
        ms = float(np.median(times[joint]))
        fams, per_step = profile_device(
            lambda i: tr.train_step(i % len(tr.scene), False), n=2)
        busy = sum(fams.values())
        log("joint", f"{name} step: {ms:.1f} ms (median of its two rounds "
                     f"{times[joint]}); device time {busy:.1f} ms in "
                     f"{per_step} kernels; busy share {busy / ms:.2f}; peak "
                     f"memory {mem[joint]:.2f} GiB ({smi})")
        for f, fms in sorted(fams.items(), key=lambda kv: -kv[1]):
            log("profile", f"  joint-8x4 {name} {f:22s} {fms:8.2f} ms/step")
    tr.joint = True
    return launches, tr


# ----------------------------------------------------------------------
# phase 11: ray-sharded data parallelism
# ----------------------------------------------------------------------

PARALLEL_DIR = REPO / "build" / "chip_smoke_parallel"
# the two epochs of phase 11's 8 bf16 steps: epoch 1 random, epoch 2 patch
PARALLEL_EPOCHS = ((1, [0, 1, 2, 3]), (2, [4, 5, 6, 7]))
# the sharded val frame against the same frame rendered by one process:
# each rank's marcher sorts and chunks its own rays, and a ray's output
# then differs by what its chunk adds after the ray's transmittance fell
# below 1e-4, so by at most 1e-4 of the largest value (plus f32 rounding)
SHARDED_RENDER_RTOL = 1e-4


def parallel_config(spec):
    """Phase 4's joint-tuned rung with a grid refresh every 4 steps, so
    that phase 11's 8 steps span two, and its eval keeping every ray
    (``raydrop_thres`` 0): after 8 steps the raydrop head drops all of the
    val frame, which would leave the point meter (B5) nothing to score."""
    return dataclasses.replace(joint_tuned_config(spec),
                               occ_update_interval=4, raydrop_thres=0.0)


def _f32_grads(tr, fi=3):
    """One f32 step's loss and gradients (the table gradients through B2),
    left before Adam; under a mesh, the mean over its ranks."""
    rend, field = tr.renderer, tr.field
    saved = (rend.compute_dtype, field.table_grad_precision)
    rend.compute_dtype, field.table_grad_precision = torch.float32, "f32"
    try:
        field.zero_grad(set_to_none=True)
        loss, _, _ = tr.loss_and_grads(fi, False)
        grads = {k: torch.zeros_like(p) if p.grad is None
                 else p.grad.detach().clone()
                 for k, p in field.named_parameters()}
        field.zero_grad(set_to_none=True)
    finally:
        rend.compute_dtype, field.table_grad_precision = saved
    return float(loss), grads


def _parallel_epochs(tr):
    """Phase 11's 8 bf16 steps (two epochs: their EMA updates and two grid
    refreshes) -> (the epochs' losses, ms a step of each epoch)."""
    losses, ms = [], []
    for ep, order in PARALLEL_EPOCHS:
        tr.epoch = ep
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # gloo's collectives on CUDA tensors cannot be captured: the step
        # path, here and in the single process it is held to
        st = tr.train_one_epoch(order=order, use_scan=False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / len(order))
        losses.append(st.loss)
    return losses, ms


def _parallel_reference(path):
    """The single process on phase 11's config and seed: the f32 step's
    loss and gradients (saved to ``path`` for rank 0 to compare); returns
    the 8 bf16 steps' losses."""
    from nvsf_torch.train.trainer import Trainer
    spec, scene = slice_scene()
    tr = Trainer(parallel_config(spec), scene, seed=0, device="cuda")
    loss, grads = _f32_grads(tr)
    torch.save({"loss": loss, "grads": {k: g.cpu() for k, g in
                                        grads.items()}}, path)
    del grads
    return _parallel_epochs(tr)[0]


def parallel_rank(mesh, ref_path):
    """One rank of phase 11 (a): the f32 step against the single process
    (rank 0 compares), the 8 bf16 steps and the sharded eval of the val
    frame (the path whose launches count), the replicated state checked
    bit for bit, timed steps, and on rank 0 the val frame rendered by this
    process alone against the sharded render."""
    from nvsf_torch.data.synthetic import make_synthetic_scene
    from nvsf_torch.parallel.mesh import replicas_differ
    from nvsf_torch.render.sweep import render_lidar_sweep
    from nvsf_torch.train.evaluate import evaluate
    from nvsf_torch.train.trainer import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"rank": mesh.rank}
    spec, scene = slice_scene()
    t0 = time.perf_counter()
    tr = Trainer(parallel_config(spec), scene, seed=0, mesh=mesh)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0
    loss, grads = _f32_grads(tr)
    if mesh.is_main:
        ref = torch.load(ref_path, map_location=mesh.device)
        rel = {k: float((g - ref["grads"][k]).abs().max())
               / max(float(ref["grads"][k].abs().max()), 1e-30)
               for k, g in grads.items()}
        worst = max(rel, key=rel.get)
        out["f32"] = dict(loss=loss, ref_loss=ref["loss"], worst=worst,
                          err=rel[worst])
        del ref
    del grads

    kernels.reset_launch_counts()
    mesh.collectives.clear()
    out["losses"], out["epoch_step_ms"] = _parallel_epochs(tr)
    out["step_collectives"] = copy.deepcopy(mesh.collectives)
    val = make_synthetic_scene(spec, split="val")
    t0 = time.perf_counter()
    with watch_lidar_sweep() as frame_render:
        res = evaluate(tr, val, use_ema=False, log_fn=None)
    torch.cuda.synchronize()
    out["eval_s"] = time.perf_counter() - t0
    out["sharded_render_s"] = frame_render["seconds"]
    sharded = frame_render["out"]
    out["launches"] = kernels.launch_counts()
    out["eval"] = res["combined"]
    out["differ"] = replicas_differ(mesh, tr.replicated_state())
    out["n_replicated"] = len(tr.replicated_state())
    if mesh.is_main:
        t0 = time.perf_counter()
        single = render_lidar_sweep(
            tr.renderer, val.poses_lidar, val.times, val.H_lidar,
            val.W_lidar, val.intrinsics_lidar, val.intrinsics_hoz_lidar,
            occ_kwargs=tr._occ_kwargs(tr.occ_grid_lidar, lidar=True))
        torch.cuda.synchronize()
        out["single_render_s"] = time.perf_counter() - t0
        out["render_err"] = {
            k: float(np.abs(sharded[k] - single[k]).max())
            / max(float(np.abs(single[k]).max()), 1e-30) for k in single}
    mesh.barrier()
    out["step_ms"], out["host_ms"] = _time_steps(tr, False, n=2, warmup=1)
    return out


def parallel_two_ranks():
    """Phase 11 (a): two ranks on the one card over gloo, against the
    single process. Returns the ranks' results."""
    import tempfile
    from nvsf_torch.parallel.mesh import spawn
    tmp = Path(tempfile.mkdtemp(prefix="nvsf_parallel_"))
    try:
        ref_path = tmp / "reference.pt"
        t0 = time.perf_counter()
        ref_losses = _parallel_reference(ref_path)
        torch.cuda.empty_cache()
        log("parallel", f"single process reference (f32 step, 8 bf16 "
                        f"steps) in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        ranks = spawn(parallel_rank, 2, (str(ref_path),), device="cuda:0",
                      backend="gloo", timeout=600.0)
        t_ranks = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    r0 = ranks[0]
    f32 = r0["f32"]
    log("parallel", f"(a) 2 ranks over gloo on cuda:0, joint-tuned "
                    f"(2048 + 2048 rays, 1024 + 1024 a rank): spawn, setup "
                    f"and checks {t_ranks:.1f} s (trainer setup "
                    f"{r0['setup_s']:.1f} s a rank)")
    log("parallel", f"f32 step, 2 ranks vs 1 process: loss {f32['loss']!r} "
                    f"vs {f32['ref_loss']!r}; worst gradient {f32['worst']} "
                    f"{f32['err']:.3e} of its max (tol 1e-5)")
    assert abs(f32["loss"] - f32["ref_loss"]) <= 1e-5 * abs(f32["ref_loss"])
    assert f32["err"] <= 1e-5, \
        f"2-rank gradients vs 1 process: {f32['worst']} {f32['err']:.3e}"
    for r in ranks:
        assert r["differ"] == [], \
            f"rank {r['rank']}: state differs from rank 0: {r['differ']}"
        assert all(np.isfinite(v) for v in r["losses"])
    assert ranks[1]["losses"] == r0["losses"]
    log("parallel", f"bf16 epochs (random, patch; 4 steps each, 2 grid "
                    f"refreshes): 2 ranks {r0['losses']}, 1 process "
                    f"{ref_losses}; {r0['n_replicated']} replicated tensors "
                    f"(params, EMA, Adam moments, U-Net, grids, error maps) "
                    f"bit for bit equal on both ranks")
    ev = r0["eval"]
    bad = [k for k in ("point", "depth", "raydrop")
           if not np.all(np.isfinite(np.asarray(ev[k])[:2]))]
    assert not bad, f"sharded eval: non-finite {bad}: {ev}"
    err = r0["render_err"]
    log("parallel", f"sharded eval of the val frame {r0['eval_s']:.1f} s, "
                    f"its LiDAR render {r0['sharded_render_s']:.1f} s "
                    f"(point {ev['point']}, depth {ev['depth']}); the frame "
                    f"rendered by rank 0 alone in "
                    f"{r0['single_render_s']:.1f} s, sharded vs alone: "
                    + ", ".join(f"{k} {v:.2e}" for k, v in err.items())
                    + f" of the max (tol {SHARDED_RENDER_RTOL})")
    assert max(err.values()) <= SHARDED_RENDER_RTOL, err
    steps = sum(len(o) for _, o in PARALLEL_EPOCHS)
    coll = r0["step_collectives"]
    log("parallel", "collectives a step (rank 0, mean of the 8): " + "; ".join(
        f"{k} {v['calls'] / steps:.2f} calls {v['bytes'] / steps / 2**20:.2f}"
        f" MiB" for k, v in coll.items()))
    return ranks


def parallel_cli():
    """Phase 11 (b): the CLI with ``--mesh_shape 1`` (one rank over NCCL)
    on phase 7's argv, cut to 2 epochs and 20 refine steps, with its val
    evals at raydrop threshold 0. Returns the rank's summary and its ms a step."""
    from nvsf_torch.scripts.main_nvsf import main as cli_main
    ws = PARALLEL_DIR / "cli"
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    argv = [
        "--config", str(REPO / "configs" / "kitti360_1908.txt"),
        "--dataloader", "synthetic", "--num_frames", "8",
        "--intrinsics_lidar", "10.0", "40.0", "--lidar_max_depth", "30",
        "--epochs", "2", "--eval_interval", "2", "--refine_steps", "20",
        # after 2 epochs the raydrop head drops every ray of the val frame
        # at 0.5 (phase 7 needs more than 4 epochs): at 0 the point meter
        # of the plain eval has points, and both matrices are held whole
        "--raydrop_thres", "0",
        "--ema_decay", "0.5", "--workspace", str(ws), "--mesh_shape", "1"]
    t0 = time.perf_counter()
    (cli,) = cli_main(argv)
    t_cli = time.perf_counter() - t0
    name = "nvsf"
    assert cli["epoch"] == 2 and cli["has_unet"], cli
    written = [Path(p).name for p in cli["checkpoints"]]
    assert len(written) == len(set(written)), f"written twice: {written}"
    assert {f"{name}_ep0002.pkl", f"{name}_refine.pkl"} <= set(written) \
        == set(p.name for p in (ws / "checkpoints").iterdir()), written
    matrices = {}
    for stem in (f"{name}_ep0002", f"{name}_ep0002_refined"):
        m = json.loads((ws / "validation" / f"{stem}_error_matrix_combined"
                        ".json").read_text())
        bad = _finite_meters(m)
        assert not bad, f"{stem}: non-finite {bad}: {m}"
        matrices[stem] = m
    # ms a step of the last epoch (2, a patch epoch), as phase 7's
    cli_ms = (cli["last_timers"]["train epoch"] * 1e3
              / (cli["global_step"] / cli["epoch"]))
    log("parallel", f"(b) --mesh_shape 1 through the CLI (one rank, NCCL): "
                    f"{t_cli:.1f} s with the spawn; checkpoints {written}; "
                    f"eval point {matrices[f'{name}_ep0002']['point']}, "
                    f"refined {matrices[f'{name}_ep0002_refined']['point']};"
                    f" collectives {cli['collectives']}")
    return cli, cli_ms


def phase_parallel(smi, slice_step_ms, cli_step_ms):
    """Phase 11: (a) two ranks on one card over gloo against the single
    process, (b) one rank over NCCL through the CLI. Returns the launches
    of both runs' ranks."""
    t_phase = time.perf_counter()
    ranks = parallel_two_ranks()
    r0 = ranks[0]
    cli, cli_ms = parallel_cli()
    log("parallel", f"step times: joint-tuned, 1 process (phase 4) "
                    f"{slice_step_ms:.1f} ms, 2 ranks over gloo on one card "
                    f"{r0['step_ms']:.1f} ms (host returns after "
                    f"{r0['host_ms']:.1f} ms); the shipped config through "
                    f"the CLI, a step of its last (patch) epoch: 1 process "
                    f"(phase 7, epoch 12) {cli_step_ms:.1f} ms, 1 rank over "
                    f"NCCL (epoch 2) {cli_ms:.1f} ms ({smi})")
    launches = {k: r0["launches"][k] + ranks[1]["launches"][k]
                + cli["launches"][k] for k in r0["launches"]}
    missing = [k for k in TRAIN_KERNELS + ("chamfer_min_dist",)
               if launches[k] == 0]
    assert not missing, f"kernels not launched under the mesh: {missing}"
    log("parallel", f"launches (both ranks of (a), the rank of (b)) "
                    f"{launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------------
# phase 12: the captured step (use_scan=True) against the eager step
# ----------------------------------------------------------------------

# each replay's loss, gradients, error-map rows and refreshed grids against
# the eager step's on the same state and draws, per tensor against its
# largest magnitude: B1/B2 and B4's atomic sums change order between runs
# (phase 11 saw 1.1e-6 between two processes' f32 gradients)
GRAPH_RTOL = 1e-5


def graph_config(spec):
    """Phase 4's joint-tuned rung in f32 (the table gradients through B2)
    with a grid refresh every 4 steps, so that phase 12's 8 random steps
    cross two refreshes."""
    return dataclasses.replace(joint_tuned_config(spec), fp16=False,
                               occ_update_interval=4)


@torch.no_grad()
def _copy_step_state(src, dst):
    """``src``'s parameters, Adam state, grids, error maps and generator
    state into ``dst``'s tensors, in place: Adam's eps of 1e-15 turns an
    atomic-order difference in a near-zero gradient into a parameter
    difference the size of the learning rate, so each step starts the two
    trainers from one state."""
    for p, q in zip(src.field.parameters(), dst.field.parameters()):
        q.copy_(p)
        if p in src.optimizer.state:
            for k, v in src.optimizer.state[p].items():
                dst.optimizer.state[q][k].copy_(v)
    for k in ("occ_grid_lidar", "occ_grid_rgb", "error_map",
              "error_map_rgb"):
        getattr(dst, k).copy_(getattr(src, k))
    dst.generator.set_state(src.generator.get_state())


def _rel_err(got, ref):
    return float((got - ref).abs().max()) \
        / max(float(ref.abs().max()), 1e-30)


def _check_em_row(old, got, ref, inds, err, H, W):
    """An error-map row written by a step against the eager step's: equal
    (GRAPH_RTOL of the row's max) where one ray wrote a cell; where several
    did, which write lands is unspecified, so each such cell must hold one
    of its rays' values. Returns the worst error over the row's max."""
    He, We = old.shape
    ey = ((inds // W).to(torch.float32) * (He / H)).to(torch.int64)
    ex = ((inds % W).to(torch.float32) * (We / W)).to(torch.int64)
    cell = ey * We + ex
    e = err.to(torch.float32)
    e = (e - e.min()) / (e.max() - e.min() + torch.finfo(torch.float32).eps)
    cand = 0.1 * old.reshape(-1)[cell] + 0.9 * (e * (1e3 - 1.0) + 1.0)
    scale = float(ref.abs().max())
    miss = (got.reshape(-1)[cell] - cand).abs()
    best = torch.full((He * We,), float("inf"), device=old.device)
    best.scatter_reduce_(0, cell, miss, "amin")
    hits = torch.bincount(cell, minlength=He * We)
    once = hits == 1
    d = (got - ref).abs().reshape(-1)
    worst = max(float(torch.where(once, d, 0.0).max()),
                float(torch.where(hits > 1, best, 0.0).max()),
                float(torch.where(hits == 0, d, 0.0).max()))
    return worst / scale


def phase_graph(smi):
    """Phase 12: a trainer stepping through ``scan_step`` (its first two
    steps of each mode eager warm-ups, then replays of the captured step)
    against a second trainer stepping eagerly, both f32 at phase 4's width.
    Before each step the eager one takes the graphed one's state; after it
    their losses, every gradient, the error-map rows written and (after a
    refresh) the grids must agree within GRAPH_RTOL of each tensor's max.
    The order is 2 x occ_update_interval frames from global step 0, cut as
    the scanned epoch cuts it, both refreshing after each dispatch; then 3
    patch steps (two warm-ups and the patch capture). Also checks that the
    learning-rate tensors a replay reads follow the schedule, that two
    consecutive replays draw different rays and that the replay draws the
    eager step's rays from the same generator state. Returns the launch
    counts of the graphed trainer's steps."""
    from nvsf_torch.data import sampler
    from nvsf_torch.train.trainer import Trainer
    spec, scene = slice_scene()
    cfg = graph_config(spec)
    t_phase = time.perf_counter()
    g = Trainer(cfg, scene, seed=0, device="cuda")
    e = Trainer(cfg, scene, seed=0, device="cuda")
    with torch.no_grad():
        # an empty half-space, so that a refresh changes what the step's
        # compaction keeps (a grid read at a stale address would show)
        G = cfg.occ_grid_size
        for grid in (g.occ_grid_lidar, g.occ_grid_rgb):
            grid[:, :, :G // 2 - 3] = 0.0
    # the sampler's draws and the error-map inputs of every step, recorded
    # by wrapping the module attributes the step calls; a capture records
    # the graph's static buffers, which each replay overwrites
    rec = {"inds": None, "em": None}
    orig_si, orig_em = sampler.sample_indices, sampler.update_error_map

    def si(*a, **k):
        out = orig_si(*a, **k)
        if rec["inds"] is not None:
            rec["inds"].append(out)
        return out

    def em(row, inds, err, H, W):
        if rec["em"] is not None:
            rec["em"].append((row, inds, err, H, W))
        return orig_em(row, inds, err, H, W)

    static, prev_replay = {}, None
    worst = {"loss": 0.0, "grad": 0.0, "em": 0.0, "grid": 0.0, "lr": 0.0}
    kernels.reset_launch_counts()

    def step(fi, patch):
        nonlocal prev_replay
        _copy_step_state(g, e)
        lrs = [b * 0.1 ** min(g.global_step / max(cfg.iters, 1), 1.0)
               for b in (cfg.lr, 0.1 * cfg.lr)]
        for grp, lr in zip(g.optimizer.param_groups, lrs):
            assert torch.is_tensor(grp["lr"]), "lr is not a device tensor"
            worst["lr"] = max(worst["lr"], abs(float(grp["lr"]) - lr) / lr)
        rec["inds"] = g_inds = []
        mg = g.scan_step(fi, patch)
        rec["inds"] = None
        replay = patch in g.step_graphs.graphs
        if replay and g_inds:               # captured (and replayed) now
            static[patch] = g_inds
        inds_g = [t.clone() for t in (static[patch] if replay else g_inds)]
        g_grads = [p.grad.clone() for p in g.field.parameters()]
        g_rows = [m[fi].clone() for m in (g.error_map, g.error_map_rgb)]
        old = [m[fi].clone() for m in (e.error_map, e.error_map_rgb)]
        rec["inds"], rec["em"] = e_inds, e_em = [], []
        me = e.train_step(fi, patch)
        rec["inds"] = rec["em"] = None
        assert len(inds_g) == len(e_inds) and all(
            torch.equal(a, b) for a, b in zip(inds_g, e_inds)), \
            f"step {g.global_step}: the graphed step drew other rays than " \
            "the eager step from the same generator state"
        if replay and prev_replay is not None and prev_replay[0] == patch:
            assert not all(torch.equal(a, b) for a, b in
                           zip(prev_replay[1], inds_g)), \
                "two consecutive replays drew the same rays"
        prev_replay = (patch, inds_g) if replay else None
        worst["loss"] = max(worst["loss"],
                            _rel_err(mg["loss"], me["loss"]))
        for k, v in me.items():
            assert _rel_err(mg[k], v) <= GRAPH_RTOL, \
                (g.global_step, k, float(mg[k]), float(v))
        for (name, p), gg in zip(e.field.named_parameters(), g_grads):
            r = _rel_err(gg, p.grad)
            worst["grad"] = max(worst["grad"], r)
            assert r <= GRAPH_RTOL, \
                f"step {g.global_step}: gradient {name} {r:.3e} of its max"
        for (row, inds, err, H, W), o, got in zip(e_em, old, g_rows):
            ref = (e.error_map if H == scene.H_lidar else
                   e.error_map_rgb)[fi]
            r = _check_em_row(o, got, ref, inds, err, H, W)
            worst["em"] = max(worst["em"], r)
            assert r <= GRAPH_RTOL, \
                f"step {g.global_step}: error-map row {fi} {r:.3e}"
        return replay

    sampler.sample_indices, sampler.update_error_map = si, em
    replays = 0
    try:
        order = np.arange(2 * cfg.occ_update_interval) % len(scene)
        g.epoch = e.epoch = 1
        for chunk in g.dispatches(order, True):
            for fi in chunk:
                replays += step(int(fi), False)
            _copy_step_state(g, e)
            g.maybe_update_occ()
            e.maybe_update_occ()
            for k in ("occ_grid_lidar", "occ_grid_rgb"):
                r = _rel_err(getattr(g, k), getattr(e, k))
                worst["grid"] = max(worst["grid"], r)
                assert r <= GRAPH_RTOL, f"{k} after the refresh: {r:.3e}"
        assert g.occ_refresh_count == e.occ_refresh_count == 2
        g.epoch = e.epoch = 2
        for fi in range(3):
            replays += step(fi, True)
    finally:
        sampler.sample_indices, sampler.update_error_map = orig_si, orig_em
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    sg = g.step_graphs
    assert sorted(sg.graphs) == [False, True] and replays == 7, \
        (sorted(sg.graphs), replays)
    assert worst["lr"] <= 1e-6, f"learning rates off the schedule: {worst}"
    log("graph", f"{replays} replays ({sg.replays}) against eager steps, "
                 f"f32, 2048 + 2048 rays, refreshes at global steps 4 and "
                 f"8: worst loss {worst['loss']:.2e}, gradient "
                 f"{worst['grad']:.2e}, error-map row {worst['em']:.2e}, "
                 f"grid {worst['grid']:.2e} of the tensor's max (tol "
                 f"{GRAPH_RTOL:g}); lr {worst['lr']:.2e} off the schedule; "
                 f"the replays drew the eager step's rays from the same "
                 f"generator state, and consecutive replays other rays; "
                 f"capture {sg.capture_s[False]:.2f} s random, "
                 f"{sg.capture_s[True]:.2f} s patch; launches {launches}; "
                 f"phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# ----------------------------------------------------------------------
# phase 14: the JAX package's last jitted programs, graphed against eager
# ----------------------------------------------------------------------

# the refresh's grids and the export's sigma: the same kernels on the same
# inputs, so 0 or the rounding of another cuBLAS algorithm under capture
PROGRAM_RTOL = 1e-6
# the refine step's loss, gradients, parameters and BatchNorm statistics:
# cuDNN's backward algorithms may sum in another order
REFINE_RTOL = 1e-5
REFINE_CHECKED = 22          # 2 eager warm-ups, the capture, 20 replays


def _wall_ms(fn) -> float:
    """Wall ms of ``fn()`` between two synchronisations."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _eager_graphed(what, eager, graphed, n, smi, profiled=2):
    """``eager`` and ``graphed`` timed in turns, ``n`` times each, then
    each profiled (device activity only: the eager density query's 80k
    kernels and their host events took the profiler longer to gather than
    the query): logs and returns {kind: (median wall ms, device ms,
    kernels a call)}."""
    fns = {"eager": eager, "graphed": graphed}
    walls = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            walls[k].append(_wall_ms(fn))
    out = {}
    for k, fn in fns.items():
        fams, kern = profile_device(lambda i: fn(), n=profiled, host=False)
        dev_ms, ms = sum(fams.values()), float(np.median(walls[k]))
        out[k] = (ms, dev_ms, kern)
        log("programs", f"{what}, {k}: wall {ms:.2f} ms (median of "
                        f"{np.round(walls[k], 2).tolist()}), device "
                        f"{dev_ms:.2f} ms in {kern} kernels, busy "
                        f"{dev_ms / ms:.2f} ({smi})")
    return out


def _program_line(what, prog):
    gib = pool_gib(prog.pool)
    log("programs", f"{what}: captured in {prog.capture_s:.2f} s after "
                    f"{prog.warm} eager warm-ups, {prog.replays} replays, "
                    f"pool {gib:.3f} GiB, launches a replay "
                    f"{ {k: n for k, n in prog.launches.items() if n} }")


def _programs_path(tr):
    """The phase's path: one refresh and the default mesh grid's density
    query on the card, each a replay of its graph, the counts zeroed just
    before (the query's first chunk is its eager warm-up, at its first
    call)."""
    cfg = tr.cfg
    kernels.reset_launch_counts()
    tr.refresh_occupancy(0xACC1)
    refresh = kernels.launch_counts()
    from nvsf_torch.render.export import extract_density_grid
    extract_density_grid(tr, cfg.mesh_bound_min, cfg.mesh_bound_max,
                         tuple(cfg.mesh_xyz_res))
    launches = kernels.launch_counts()
    assert refresh["multihot_fwd"] > 0 and \
        launches["multihot_fwd"] > refresh["multihot_fwd"], launches
    log("programs", f"launches of the path: the refresh {refresh}, with the "
                    f"density query {launches}")
    return launches


def capture_program_inputs(tr):
    """The inputs of B3's launches on the phase's path, as
    ``capture_eval_inputs`` records a render slab's: the first call of each
    shape in one eager refresh of the trainer's grids (the refresh's graph
    launches the same kernels at the same shapes; the grids are put back
    after it) and in the default mesh grid's eager density query (every
    chunk of 65,536 points has the same shapes)."""
    from nvsf_torch.render.export import extract_density_grid
    cfg = tr.cfg
    calls = {"refresh": [], "query": []}
    orig = mh.multihot_fwd_cuda
    grids = tr._occ_grids()
    saved = [g.clone() for g in grids]

    def recording(what):
        def fwd(tables, cols, ws, W):
            if all(c[1].shape != cols.shape or c[3] != W
                   for c in calls[what]):
                calls[what].append((_keep(tables), _keep(cols), _keep(ws),
                                    W))
            return orig(tables, cols, ws, W)
        return fwd

    try:
        mh.multihot_fwd_cuda = recording("refresh")
        tr.refresh_occupancy(0xACC4, graphed=False)
        mh.multihot_fwd_cuda = recording("query")
        extract_density_grid(tr, cfg.mesh_bound_min, cfg.mesh_bound_max,
                             tuple(cfg.mesh_xyz_res), graphed=False)
        torch.cuda.synchronize()
    finally:
        mh.multihot_fwd_cuda = orig
        for g, s in zip(grids, saved):
            g.copy_(s)
    return calls


def phase_program_kernels(tr):
    """Phase 3's "programs" rows: B3 on the inputs of the refresh's and
    the density query's launches, static and dynamic planes, each against
    its plain version and timed beside its bound and embedding_bag."""
    rows = {"multihot_fwd": []}
    for what, calls in capture_program_inputs(tr).items():
        assert len(calls) == 2, f"expected the static and the dynamic " \
            f"planes' B3 launch in the {what}, got {len(calls)}"
        for tables, cols, ws, W in calls:
            Q, S, C, Np = cols.shape
            rows["multihot_fwd"].append(multihot_fwd_row(
                f"programs {what} Q={Q} S={S} C={C} W={W} "
                f"F={tables.shape[0]} Np={Np}", tables, cols, ws, W))
    report_kernels(rows)
    return rows


def _check_refresh(tr, smi):
    """(a): the refresh at the trainer's cadence, graphed against eager."""
    grids = tr._occ_grids()
    saved = [g.clone() for g in grids]

    def restore():
        for g, s in zip(grids, saved):
            g.copy_(s)

    worst = 0.0
    for seed in (0xACC2, 0xACC3):
        restore()
        tr.refresh_occupancy(seed)
        got = [g.clone() for g in grids]
        restore()
        tr.refresh_occupancy(seed, graphed=False)
        for a, b, s in zip(got, grids, saved):
            assert not torch.equal(b, s), "the refresh changed no cell"
            worst = max(worst, _rel_err(a, b))
    assert worst <= PROGRAM_RTOL, f"refresh graphed vs eager {worst:.3e}"
    restore()
    torch.cuda.synchronize()
    with sync_errors():
        tr.refresh_occupancy(0xACC5)
    torch.cuda.synchronize()
    occ = tr.occ
    log("programs", f"refresh (G {occ.grid_size}, 1/{occ.update_fraction} "
                    f"of the cells, {tr.cfg.occ_time_samples} times, "
                    f"{len(grids)} grids): graphed vs eager worst "
                    f"{worst:.3e} of the grid's max (tol {PROGRAM_RTOL:g}) "
                    f"at 2 seeds; a replay under set_sync_debug_mode"
                    f"('error'): no host sync")
    _eager_graphed("refresh", lambda: tr.refresh_occupancy(7, graphed=False),
                   lambda: tr.refresh_occupancy(7), 5, smi)
    restore()
    _program_line("refresh graph", tr._refresh_program())


@torch.no_grad()
def _sync_refine(src, dst):
    """``src``'s U-Net, Adam state and generator state into ``dst``'s
    tensors, in place (Adam's normalised step turns an atomic-order
    difference in a near-zero gradient into one the size of the rate, so
    each step starts both from one state)."""
    for p, q in zip(src.unet.parameters(), dst.unet.parameters()):
        q.copy_(p)
        for k, v in src.opt.state.get(p, {}).items():
            dst.opt.state[q][k].copy_(v)
    for a, b in zip(src.unet.buffers(), dst.unet.buffers()):
        b.copy_(a)
    dst.generator.set_state(src.generator.get_state())


def _refine_snapshot(rs):
    """Clones of ``rs``'s parameters and Adam state, by parameter."""
    return {p: (p.detach().clone(), {k: v.clone() for k, v in
                                     rs.opt.state.get(p, {}).items()})
            for p in rs.unet.parameters()}


@torch.no_grad()
def adam_on(rs, snap, grads):
    """``rs``'s Adam step once more, from the parameters and state of
    ``snap`` (a missing state: Adam's zeros) on the gradients ``grads``,
    at the rate ``rs`` holds."""
    for p, g in zip(rs.unet.parameters(), grads):
        p0, st0 = snap[p]
        p.copy_(p0)
        p.grad.copy_(g)
        for k, v in rs.opt.state[p].items():
            v.copy_(st0[k]) if k in st0 else v.zero_()
    rs.opt.step()


def _refine_steps(tr, unet, x, gt, graphed=None):
    """A ``RefineSteps`` of the shipped 1000-step stage on ``unet``."""
    from nvsf_torch.train.refine import RefineSteps
    # Trainer.refine's rate
    return RefineSteps(unet, x, gt, steps=tr.cfg.refine_steps, lr=1e-3,
                       graphed=graphed)


def _refine_pair(tr, x, gt):
    """A graphed and an eager ``RefineSteps`` on two copies of the
    trainer's U-Net."""
    unet = copy.deepcopy(tr.unet).train()
    return (_refine_steps(tr, unet, x, gt),
            _refine_steps(tr, copy.deepcopy(unet), x, gt, graphed=False))


def _check_refine(tr, smi):
    """(b): the refine step at the bench scene's shape, graphed against
    eager, and its times in f32 and with cuDNN's TF32."""
    pred = tr.render_lidar_frame(0)
    scene = tr.scene
    B = len(scene)
    gen = torch.Generator(device="cuda").manual_seed(14)
    frame = torch.as_tensor(np.stack([pred["raydrop"], pred["intensity"],
                                      pred["depth"]]), device="cuda")
    x = frame.expand(B, *frame.shape) + 0.05 * torch.randn(
        (B, *frame.shape), generator=gen, device="cuda")
    gt = torch.as_tensor(scene.images_lidar[:, None, :, :, 0],
                         dtype=torch.float32, device="cuda")
    g, e = _refine_pair(tr, x, gt)
    # a second eager copy: the gaps two eager runs of a step show
    twin = _refine_steps(tr, copy.deepcopy(e.unet), x, gt, graphed=False)
    worst = {"loss": 0.0, "gradient": 0.0, "statistic": 0.0,
             "parameter": 0.0, "Adam moment": 0.0, "own-step parameter": 0.0,
             "eager twin gradient": 0.0,
             "eager twin own-step parameter": 0.0}
    where = {}

    def note(items):
        """Each (kind, name, got, ref)'s relative error, read in one host
        synchronisation, into ``worst``."""
        errs = torch.stack([(a.float() - b.float()).abs().max()
                            / b.float().abs().max().clamp_min(1e-30)
                            for _, _, a, b in items]).tolist()
        for (kind, name, _, _), err in zip(items, errs):
            if err > worst[kind]:
                worst[kind], where[kind] = err, name

    for i in range(REFINE_CHECKED):
        _sync_refine(g, e)
        _sync_refine(g, twin)
        snap = _refine_snapshot(e)
        lg, le = float(g.step(i)), float(e.step(i))
        twin.step(i)
        if abs(lg - le) / abs(le) > worst["loss"]:
            worst["loss"], where["loss"] = abs(lg - le) / abs(le), i
        named = list(zip(g.unet.named_parameters(), e.unet.parameters(),
                         twin.unet.parameters()))
        items = [(kind, f"{k} step {i}", a, b)
                 for (k, p), q, r in named
                 for kind, a, b in (
                     ("gradient", p.grad, q.grad),
                     ("own-step parameter", p.detach(), q.detach()),
                     ("eager twin gradient", r.grad, q.grad),
                     ("eager twin own-step parameter", r.detach(),
                      q.detach()))]
        items += [("statistic", f"{k} step {i}", b, c) for (k, b), c in
                  zip(g.unet.named_buffers(), e.unet.buffers())]
        note(items)
        # the eager Adam step again, on the replay's gradients: Adam's
        # step m / (sqrt(v) + 1e-8) turns the backward's summation-order
        # differences in a gradient near 1e-8 into ones the size of the
        # rate, so the parameters are held to the same update of the same
        # gradients
        adam_on(e, snap, [p.grad for p in g.unet.parameters()])
        note([("parameter", f"{k} step {i}", p.detach(), q.detach())
              for (k, p), q, _ in named]
             + [("Adam moment", f"{k} {m} step {i}", v, e.opt.state[q][m])
                for (k, p), q, _ in named
                for m, v in g.opt.state[p].items()])
    assert g.program.replays == REFINE_CHECKED - 2 and g.program.warm == 2
    bad = {k: v for k, v in worst.items()
           if "own-step" not in k and "twin" not in k
           and not v <= REFINE_RTOL}
    log("programs", f"refine step on {tuple(x.shape)}: {REFINE_CHECKED} "
                    f"steps (2 eager warm-ups, {g.program.replays} replays)"
                    f" against eager steps from the same state: worst "
                    + ", ".join(f"{k} {v:.3e} ({where.get(k)})"
                                for k, v in worst.items())
                    + f" of each tensor's max (tol {REFINE_RTOL:g}; the "
                    f"parameters and moments after the eager Adam step on "
                    f"the replay's gradients; 'own-step parameter': after "
                    f"each side's own step, reported; 'eager twin': a "
                    f"second eager copy from the same state against the "
                    f"first, reported)")
    assert not bad, f"refine graphed vs eager: {bad}"
    del twin
    with sync_errors():
        g.step(REFINE_CHECKED)
    torch.cuda.synchronize()
    log("programs", "refine: a replay under set_sync_debug_mode('error'): "
                    "no host sync")
    i = REFINE_CHECKED + 1
    _eager_graphed("refine step, f32 convolutions (cudnn.allow_tf32 False,"
                   " the script's)", lambda: e.step(i), lambda: g.step(i), 3,
                   smi)
    _program_line("refine graph, f32", g.program)
    del g, e
    torch.backends.cudnn.allow_tf32 = True
    try:
        g, e = _refine_pair(tr, x, gt)
        for j in range(3):
            g.step(j), e.step(j)
        _eager_graphed("refine step, cuDNN TF32 (cudnn.allow_tf32 True, "
                       "torch's default, which the CLI keeps)",
                       lambda: e.step(3), lambda: g.step(3), 3, smi)
        _program_line("refine graph, TF32", g.program)
    finally:
        torch.backends.cudnn.allow_tf32 = False


def _check_export(tr, smi):
    """(c): the mesh export's density query at the default grid, graphed
    against eager, and the iso-surface timed apart."""
    from nvsf_torch.render.export import (extract_density_grid,
                                          marching_tetrahedra)
    cfg = tr.cfg
    res = tuple(cfg.mesh_xyz_res)
    bmin, bmax = cfg.mesh_bound_min, cfg.mesh_bound_max

    def query(graphed):
        return extract_density_grid(tr, bmin, bmax, res, graphed=graphed)

    walls, grids = {"eager": [], "graphed": []}, {}
    for _ in range(2):                       # in turns
        for kind in walls:
            walls[kind].append(_wall_ms(lambda: grids.__setitem__(
                kind, query(kind == "graphed"))))
    got, ref = grids["graphed"], grids["eager"]
    err = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()),
                                               1e-30)
    assert np.isfinite(got).all() and err <= PROGRAM_RTOL, \
        f"density query graphed vs eager {err:.3e}"
    prog = tr.programs[("density query", 65536, True)]
    pts = torch.rand((65536, 3), device="cuda") - 0.5
    t = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    with sync_errors():
        prog(pts=pts, t=t)
    torch.cuda.synchronize()
    n = int(np.prod(res))
    chunks = -(-n // 65536)
    log("programs", f"density query of the {'x'.join(map(str, res))} mesh "
                    f"grid ({n} points, {chunks} chunks of 65536): "
                    f"graphed vs eager {err:.3e} of sigma's max (tol "
                    f"{PROGRAM_RTOL:g}); a replay under set_sync_debug_mode"
                    f"('error'): no host sync")
    # device time: one chunk profiled (every chunk has the same shapes;
    # the whole grid's 80k kernels took the profiler longer than the
    # query), times the chunks
    chunk = {"eager": lambda: tr.ema_field.density(
        pts, t, cal_lidar_color=True)["sigma"],
        "graphed": lambda: prog(pts=pts, t=t)}
    for kind, fn in chunk.items():
        fams, kern = profile_device(lambda i: fn(), n=2, host=False)
        dev_ms, ms = sum(fams.values()) * chunks, float(np.median(walls[kind]))
        log("programs", f"density query, {kind}: wall {ms:.2f} ms (median "
                        f"of {np.round(walls[kind], 2).tolist()}), device "
                        f"{dev_ms:.2f} ms in {kern * chunks} kernels ({chunks}"
                        f" x one chunk's), busy {dev_ms / ms:.2f} ({smi})")
    _program_line("density query graph", prog)
    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(got, cfg.density_thresh, bmin, bmax)
    log("programs", f"iso-surface (numpy marching tetrahedra, threshold "
                    f"{cfg.density_thresh}): {time.perf_counter() - t0:.2f}"
                    f" s, {len(faces)} faces")


def _check_ema(tr, smi):
    """(d): the EMA update, one call, against the loop it replaced."""
    decay = tr.cfg.ema_decay
    loop = {k: v.clone() for k, v in tr.ema.items()}

    def by_loop():
        with torch.no_grad():
            for k, p in tr.field.named_parameters():
                loop[k].mul_(decay).add_(p.detach(), alpha=1 - decay)

    loop_ms = _wall_ms(by_loop)
    ms = _wall_ms(tr.update_ema)
    differ = [k for k, v in tr.ema.items() if not torch.equal(v, loop[k])]
    log("programs", f"EMA update ({len(loop)} tensors, "
                    f"{sum(v.numel() for v in loop.values())} values): "
                    f"{ms:.3f} ms as two multi-tensor kernels, the "
                    f"per-parameter loop {loop_ms:.3f} ms; bit-equal: "
                    f"{not differ} ({smi})")
    assert not differ, f"EMA update differs from the loop: {differ}"


def phase_programs(tr, smi):
    """Phase 14 on phase 5's settled field: the occupancy refresh, the
    U-Net refine step and the mesh export's density query graphed against
    eager at the shipped widths, each replayed once under
    set_sync_debug_mode("error"), with wall and device times, captures and
    pools; the EMA update timed; B3 on the path's inputs (phase 3's
    "programs" rows). Returns the path's launches and those rows."""
    t_phase = time.perf_counter()
    launches = _programs_path(tr)
    rows = phase_program_kernels(tr)
    took = {}
    for what, check in (("refresh", _check_refresh),
                        ("refine", _check_refine),
                        ("density query", _check_export),
                        ("EMA", _check_ema)):
        t0 = time.perf_counter()
        check(tr, smi)
        took[what] = round(time.perf_counter() - t0, 1)
    log("programs", f"phase {time.perf_counter() - t_phase:.1f} s: {took}")
    return launches, rows


# ----------------------------------------------------------------------
# phase 15: the hash-grid lookup at the cells' encoder shapes
# ----------------------------------------------------------------------

# (cell, family, D, F, levels, base and max resolution, log2 T of each
# plane, points, queries, gradient): the occupancy cell's camera branch
# (2048 x 128 samples) and the dense cell's remat chunk (4096 x 768 / 8);
# the dynamic and flow tables folded over 4 bases
HASH_SHAPES = [
    ("occ", "static", 3, 8, 4, 512, 32768, (19,), 262_144, 1, True),
    ("occ", "dynamic t", 2, 2, 4, 512, 32768, (15, 13, 13), 262_144, 1,
     True),
    ("occ", "dynamic warps", 2, 2, 4, 512, 32768, (15, 13, 13), 262_144, 2,
     False),
    ("occ", "flow", 3, 8, 4, 32, 8192, (18,), 262_144, 1, True),
    ("dense", "static", 3, 4, 8, 512, 32768, (19,), 196_608, 1, True),
    ("dense", "dynamic t", 2, 1, 8, 512, 32768, (15, 13, 13), 196_608, 1,
     True),
    ("dense", "dynamic warps", 2, 1, 8, 512, 32768, (15, 13, 13), 196_608,
     2, False),
    ("dense", "flow", 3, 2, 16, 32, 8192, (18,), 196_608, 1, True),
]


def _hash_points(gen, n, dev, steps=96):
    """n points in [0, 1]^3, ``steps`` consecutive samples along each of
    n / steps random rays (a step's ray order)."""
    rays = -(-n // steps)
    o = torch.rand((rays, 1, 3), generator=gen, device=dev) * 0.4 + 0.3
    d = nnf.normalize(torch.randn((rays, 1, 3), generator=gen, device=dev),
                      dim=-1)
    z = torch.linspace(0, 0.5, steps, device=dev)[None, :, None]
    return (o + d * z).reshape(-1, 3)[:n].clamp(0, 1).contiguous()


def _sector_bytes(cols, F):
    """Bytes of the distinct 32-byte sectors of a row-major [*, F] f32
    table that the slots ``cols`` touch."""
    if 4 * F >= 32:
        return int(torch.unique(cols).numel()) * 4 * F
    return int(torch.unique(cols.long() * (4 * F) // 32).numel()) * 32


def _lookup_desc(queries, res, shape):
    pl = queries[0].planes
    return (f"D={len(pl[0].axes)} F={shape[1]} L={len(res)} S={shape[0]} "
            f"P={len(pl)} N={queries[0].x.shape[0]} x {len(queries)}")


def _plane_cols_weights(q, pl, res):
    """The plain composition's (cols, wc) of one plane of a query."""
    from nvsf_torch.ops import hash_lookup as hl
    c, wc = hl.level_cols_weights(q.x[:, list(pl.axes)], res,
                                  1 << pl.log2_T)
    return c + pl.slot0, wc


def _lookup_work(queries, res, F):
    """(bytes of the points' columns read once, of the features written
    once, flops) of the lookups."""
    L = len(res)
    x_bytes = out_bytes = ops = 0
    for q in queries:
        N, P = q.x.shape[0], len(q.planes)
        D = len(q.planes[0].axes)
        x_bytes += 4 * N * len({a for pl in q.planes for a in pl.axes})
        out_bytes += 4 * N * P * L * F
        ops += 2 * (1 << D) * F * N * P * L
    return x_bytes, out_bytes, ops


def hash_fwd_row(variant, reads, queries, res):
    """The lookup's forward kernel on one call's inputs (each table a
    row-major [S, F] tensor) against the plain composition; its time, the
    plain chain's on features-major tables (the port's path before the
    kernel) and the bound: the points read, the features written, the
    table sectors the corners touch."""
    from nvsf_torch.ops import hash_lookup as hl
    F, S = reads[0].shape[1], reads[0].shape[0]
    fm_reads = [r.t().contiguous().t() for r in reads]
    ref = hl.lookup_plain(fm_reads, queries, res)
    mags = hl.lookup_plain([r.abs() for r in fm_reads], queries, res)
    n0 = kernels.launch_counts()["hash_encode_fwd"]
    got = hl.lookup_fwd_cuda(reads, queries, res)
    n_fwd = kernels.launch_counts()["hash_encode_fwd"] - n0
    err, tol, ok = 0.0, 0.0, True
    for a, b, m in zip(got, ref, mags):
        e, t, o = compare("hash fwd", a, b, m)
        err, tol, ok = max(err, e), max(tol, t), ok and o
    cols = torch.cat([_plane_cols_weights(q, pl, res)[0] + q.table * S
                      for q in queries for pl in q.planes])
    x_bytes, out_bytes, ops = _lookup_work(queries, res, F)
    b_ms, b_by = bound(x_bytes + out_bytes + _sector_bytes(cols, F), ops)
    return dict(
        variant=variant, max_abs_err=err, tol=tol, ok=ok,
        ms=device_ms(lambda: hl.lookup_fwd_cuda(reads, queries, res)),
        # the plain chains queue ~150 kernels a call: two calls fit in the
        # launch queue behind device_ms's spin, ten do not
        plain_ms=device_ms(lambda: hl.lookup_plain(fm_reads, queries, res),
                           reps=2),
        library_ms=None, bound_ms=b_ms, bound_by=b_by, launches=n_fwd)


def hash_bwd_row(variant, queries, grads, res, S, F, precision, fm):
    """The lookup's gradient kernel (B1's rows stage, fused) on one
    table's inputs against the plain version (every corner's update
    w * g, then ``segment_add_plain``), within SUM_RTOL of the sum of the
    updates' magnitudes; its time, the plain chain's backward (the port's
    path before the kernel: the composition's autograd, B1's cols/vals
    entry) and the bound: the points and the gradients read, the table
    written."""
    from nvsf_torch.ops import hash_lookup as hl
    dev = grads[0].device
    L = len(res)
    # the queries of one table: table 0 of the plain version's one
    queries = [q._replace(table=0) for q in queries]
    grads = [g.float() for g in grads]
    cols, vals = [], []
    for q, g in zip(queries, grads):
        for p, pl in enumerate(q.planes):
            c, wc = _plane_cols_weights(q, pl, res)
            gp = g[:, p * L * F:(p + 1) * L * F].reshape(-1, L, F)
            cols.append(c)
            vals.append((gp.permute(2, 1, 0)[:, :, None, :] * wc[None])
                        .reshape(F, -1))
    cols, vals = torch.cat(cols), torch.cat(vals, 1)
    ref = segsum.segment_add_plain(cols, vals, S, precision)
    mags = segsum.segment_add_plain(cols, vals.abs(), S, "f32")
    del cols, vals
    n0 = kernels.launch_counts()["hash_encode_bwd"]
    got = hl.lookup_bwd_cuda(queries, grads, res, S, F, precision, fm, dev)
    n_bwd = kernels.launch_counts()["hash_encode_bwd"] - n0
    err, tol, ok = compare("hash bwd", got.t(), ref, mags)
    del ref, mags
    tp = torch.zeros((F, S), device=dev, requires_grad=True)

    def plain_total():
        o = hl.lookup_plain([tp.t()], queries, res, precision)
        return torch.autograd.grad(o, tp, grads)

    plain_bwd = device_ms(plain_total, reps=2) - device_ms(
        lambda: hl.lookup_plain([tp.t()], queries, res, precision), reps=2)
    x_bytes, g_bytes, ops = _lookup_work(queries, res, F)
    b_ms, b_by = bound(x_bytes + g_bytes + 4 * F * S, ops)
    return dict(
        variant=variant, max_abs_err=err, tol=tol, ok=ok,
        ms=device_ms(lambda: hl.lookup_bwd_cuda(queries, grads, res, S, F,
                                                precision, fm, dev)),
        plain_ms=plain_bwd, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        launches=n_bwd)


def hash_row(gen, dev, cell, family, D, F, L, base, top, log2s, N, Q, grad):
    """The rows of one of HASH_SHAPES, on ray-ordered points: the forward
    (with the features-major read and the layouts' costs: the copy of a
    parameter, or either fold) and, with ``grad``, the bf16 gradient."""
    from nvsf_torch.models.hash_grid import (lagrange_basis,
                                             lagrange_fold_table,
                                             level_resolutions)
    from nvsf_torch.ops import hash_lookup as hl
    res = level_resolutions(base, top, L)
    planes, slot0 = [], 0
    for i, lg in enumerate(log2s):
        planes.append(hl.Plane(((0, 1), (0, 2), (1, 2))[i] if D == 2
                               else (0, 1, 2), slot0, lg))
        slot0 += L << lg
    S = slot0
    table = torch.rand((F, S), generator=gen, device=dev) * 2 - 1
    xs = [torch.cat([_hash_points(gen, N, dev), torch.full(
        (N, 1), 0.3, device=dev)], -1) for _ in range(Q)]
    queries = [hl.Query(x[:, :3], 0, tuple(planes)) for x in xs]
    rows = table.t().contiguous()
    folded = family != "static"
    row = hash_fwd_row(f"{cell} {family} "
                       f"{_lookup_desc(queries, res, rows.shape)}",
                       [rows], queries, res)
    row["fm_read_ms"] = device_ms(lambda: hl.lookup_fwd_cuda(
        [table.t()], queries, res))
    if folded:   # the fold, forward and backward, into either layout
        big = torch.rand((4 * F, S), generator=gen, device=dev,
                         requires_grad=True)
        t = torch.tensor(0.3, device=dev)

        def fold_grad(fold, gf):
            return lambda: torch.autograd.grad(fold(), big, gf)

        def fold_tensordot():   # the contraction, then the copy
            return torch.tensordot(lagrange_basis(t, 4), big.reshape(
                4, F, S), dims=1).t().contiguous()

        g_rows = torch.randn((S, F), generator=gen, device=dev)
        for key, fold in (("fold_rows_ms", lambda: lagrange_fold_table(
                big, t, 4)), ("fold_tensordot_ms", fold_tensordot)):
            row[key] = device_ms(fold_grad(fold, g_rows), reps=4)
    else:
        row["copy_ms"] = device_ms(lambda: table.t().contiguous())
    rows_out = {"hash_encode_fwd": [row]}
    if grad:
        g = [torch.randn((N, len(planes) * L * F), generator=gen,
                         device=dev) for _ in queries]
        rows_out["hash_encode_bwd"] = [hash_bwd_row(
            row["variant"] + " bf16", queries, g, res, S, F, "bf16",
            not folded)]
    return rows_out


def phase_hash():
    """Phase 15: the hash-grid lookup's kernels at each cell's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = {"hash_encode_fwd": [], "hash_encode_bwd": []}
    for shape in HASH_SHAPES:
        log("hash", f"{shape[0]} {shape[1]}")
        for name, rs in hash_row(gen, dev, *shape).items():
            rows[name] += rs
            torch.cuda.empty_cache()
    report_kernels(rows, "hash")
    for r in rows["hash_encode_fwd"]:
        extra = {k: r[k] for k in ("fm_read_ms", "copy_ms", "fold_rows_ms",
                                   "fold_tensordot_ms") if k in r}
        log("hash", f"layout [{r['variant']}]: row-major read "
                    f"{r['ms']:.4f} ms, "
                    + ", ".join(f"{k} {v:.4f}" for k, v in extra.items()))
    print(json.dumps({"hash": rows}))
    return rows


def hash_alone(smi):
    """``--phase hash``: phase 15 alone."""
    phase_hash()


def programs_alone(smi):
    """``--phase programs``: phase 14 alone, on phase 4's trainer after
    its two epochs and phase 5's settling (no checks of those phases)."""
    from nvsf_torch.train.trainer import Trainer
    spec, scene = slice_scene()
    tr = Trainer(joint_tuned_config(spec), scene, seed=0, device="cuda")
    for ep in (1, 2):
        tr.epoch = ep
        tr.train_one_epoch()
    settle_for_render(tr)
    phase_programs(tr, smi)


def render_alone(smi):
    """``--phase render``: phase 13 alone, on phase 4's trainer after its
    two epochs and phase 5's settling (no checks of those phases)."""
    from nvsf_torch.train.trainer import Trainer
    spec, scene = slice_scene()
    tr = Trainer(joint_tuned_config(spec), scene, seed=0, device="cuda")
    for ep in (1, 2):
        tr.epoch = ep
        tr.train_one_epoch()
    settle_for_render(tr)
    phase_render(tr, smi)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def done(phase):
        t = time.perf_counter() - t_start
        log("time", f"{phase} done at {t:.1f} s ({t / TARGET_S:.0%} of the "
                    f"{TARGET_S:.0f} s target)")

    smi = phase_card()
    phase_build()
    done("build")
    alone = {"render": render_alone, "programs": programs_alone,
             "hash": hash_alone}
    if len(argv) == 2 and argv[0] == "--phase" and argv[1] in alone:
        alone[argv[1]](smi)
        done(f"{argv[1]} (alone)")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if argv:
        raise SystemExit(f"usage: chip_smoke.py [--phase render|programs|"
                         f"hash], "
                         f"got {argv}")
    rows = phase_kernels()
    rows.update(phase_hash())
    done("kernels")
    tr, train_launches, slice_step_ms = phase_slice(smi)
    for name, rs in phase_step_kernels(tr).items():
        rows[name] += rs
    done("slice")
    eval_launches, eval_rows, stream = phase_eval(tr, smi)
    for name, rs in eval_rows.items():
        rows[name] += rs
    done("eval")
    render_launches = phase_render(tr, smi)
    done("render (phase 13, on phase 5's field)")
    programs_launches, program_rows = phase_programs(tr, smi)
    for name, rs in program_rows.items():
        rows[name] += rs
    done("programs (phase 14, on phase 5's field)")
    trained = {k: v.detach().clone() for k, v in tr.field.state_dict().items()}
    del tr
    torch.cuda.empty_cache()
    phase_learning()
    done("learning")
    cli_launches, cli_step_ms = phase_cli(smi)
    done("cli")
    uniform_paths, tr, _ = phase_uniform(smi, trained, stream)
    del trained
    for name, rs in phase_step_kernels(tr, "uniform", distinct=True).items():
        rows[name] += rs
    del tr
    done("uniform")
    kitti_launches = phase_kitti(smi)
    done("kitti")
    joint_launches, tr = phase_joint(smi)
    for name, rs in phase_step_kernels(tr, "joint").items():
        rows[name] += rs
    del tr
    torch.cuda.empty_cache()
    done("joint")
    parallel_launches = phase_parallel(smi, slice_step_ms, cli_step_ms)
    done("parallel")
    graph_launches = phase_graph(smi)
    done("graph")
    # B1 and B2 are one kernel with a precision flag: its rows and launches
    # split by precision
    rows["segment_add_f32"] = [r for r in rows["segment_add"]
                               if " f32 " in r["variant"]]
    rows["segment_add"] = [r for r in rows["segment_add"]
                           if " f32 " not in r["variant"]]
    paths = {"train": train_launches, "eval": eval_launches,
             "cli": cli_launches, **uniform_paths, "kitti": kitti_launches,
             "joint": joint_launches, "parallel": parallel_launches,
             "graph": graph_launches, "render": render_launches,
             "programs": programs_launches}
    # every lookup on the card runs the hash kernels: no path's table
    # gradient ran B1's cols/vals entry (the plain composition's)
    plain = {path: counts["segment_add"] for path, counts in paths.items()
             if counts["segment_add"]}
    assert not plain, f"paths that ran B1's cols/vals entry: {plain}"
    record = []
    for name, source, replaces in KERNELS:
        rs = rows[name]
        worst = max(rs, key=lambda r: r.get("err_over_tol",
                                             r["max_abs_err"] / r["tol"]))
        by_path = {path: counts[name] for path, counts in paths.items()}
        record.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces,
                           launches=sum(by_path.values()),
                           launches_by_path=by_path,
                           max_abs_err=worst["max_abs_err"],
                           ms=rs[0]["ms"], plain_ms=rs[0]["plain_ms"],
                           bound_ms=rs[0]["bound_ms"],
                           bound_by=rs[0]["bound_by"],
                           library_ms=rs[0]["library_ms"], variants=rs))
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
