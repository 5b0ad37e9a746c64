"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. card     -- a CUDA device is present; prints nvidia-smi's name and
                 power limit.
  2. build    -- compiles the kernels of nvsf_torch/csrc with nvcc.
  3. kernels  -- each kernel against its plain PyTorch version at the
                 shapes the joint training step gives it.
  4. slice    -- the joint LiDAR + camera training step (the bench.py
                 "joint-tuned" rung at full width on the synthetic scene):
                 Trainer.train_one_epoch for one random and one patch
                 epoch, then timed steady-state steps and a torch.profiler
                 breakdown of their device time by kernel family.
  5. learning -- the convergence drive of .claude/skills/verify/SKILL.md
                 (12 epochs, 4 frames) must cut the loss below 0.7x.

Any failure raises and the script exits non-zero. The line before the
last is a JSON record of the kernels; the last is
{"ok": true, "device": {...}}. Needs one GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from nvsf_torch.config import NVSFConfig
from nvsf_torch.ops import kernels
from nvsf_torch.ops import multihot as mh
from nvsf_torch.ops import segsum

# Relative error bound of an f32 sum taken in any order, per unit of the
# sum of the magnitudes of its terms: n_terms * 2^-24 stays below it for up
# to ~160 terms per output; the slot sums here have a few dozen at most.
SUM_RTOL = 1e-5


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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


def compare(name, got, ref, bound):
    """max |got - ref| against SUM_RTOL * max(bound), where ``bound`` is
    the sum of the magnitudes of the terms of each output."""
    err = float((got - ref).abs().max())
    tol = SUM_RTOL * float(bound.abs().max()) + 1e-7
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
      dynamic hash  the t-query prefix of the fused three-query gather,
                    3 planes x 4 levels x 4 corners x N updates, F 2,
                    T 4 x (2^15 + 2^13 + 2^13); its values are the first
                    third of a [2, 3M] gradient, read in place with row
                    stride 3M, as the gather's backward passes them."""
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
    grids = field.hash_lidar.dynamic_grids
    cols, _ = field.hash_lidar._dynamic_cols_weights(x)
    M = cols.shape[0]
    g = randn(grids[0].n_features_per_level // grids[0].num_basis, 3 * M)
    cases.append(("dynamic hash n_grad prefix", cols, g[:, :M],
                  sum(gr.grid.n_cols for gr in grids)))
    return cases


def check_segment_add(gen, dev):
    """B1 (bf16) and B2 (its f32 flag) at each table-gradient shape of the
    step."""
    rows = []
    for name, cols, vals, T in _segment_add_cases(gen, dev):
        F, M = vals.shape
        for prec in ("bf16", "f32"):
            got = segsum.segment_add_cuda(cols, vals, T, prec)
            ref = segsum.segment_add_plain(cols, vals, T, prec)
            bound = segsum.segment_add_plain(cols, vals.abs(), T, "f32")
            err, tol, ok = compare(f"segment_add[{prec}]", got, ref, bound)
            rows.append(dict(
                variant=f"{name} {prec} M={M} F={F} T={T} "
                        f"ld={vals.stride(0)}",
                max_abs_err=err, tol=tol, ok=ok,
                ms=cuda_ms(lambda: segsum.segment_add_cuda(cols, vals, T,
                                                           prec)),
                plain_ms=cuda_ms(lambda: segsum.segment_add_plain(
                    cols, vals, T, prec))))
    return rows


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
        Q, S, C, W, need_dw = sh["Q"], sh["S"], sh["C"], sh["W"], \
            sh["need_dw"]
        tables, cols, ws, g = _multihot_inputs(Q, S, C, W, 8, N, gen, dev,
                                               sh["lerp"])
        desc = f"Q={Q} S={S} C={C} W={W} F=8 Np={cols.shape[-1]}"
        got = mh.multihot_fwd_cuda(tables, cols, ws, W)
        ref = mh.multihot_fwd_plain(tables, cols, ws, W)
        bound = mh.multihot_fwd_plain(tables.abs(), cols, ws.abs(), W)
        err, tol, ok = compare("multihot_fwd", got, ref, bound)
        fwd_rows.append(dict(
            variant=desc, max_abs_err=err, tol=tol, ok=ok,
            ms=cuda_ms(lambda: mh.multihot_fwd_cuda(tables, cols, ws, W)),
            plain_ms=cuda_ms(lambda: mh.multihot_fwd_plain(tables, cols, ws,
                                                           W))))
        dt, dw = mh.multihot_bwd_cuda(tables, cols, ws, g, W, need_dw)
        rdt, rdw = mh.multihot_bwd_plain(tables, cols, ws, g, W, need_dw)
        bdt, bdw = mh.multihot_bwd_plain(tables.abs(), cols, ws.abs(),
                                         g.abs(), W, need_dw)
        err, tol, ok = compare("multihot_bwd.dT", dt, rdt, bdt)
        if need_dw:
            e2, t2, ok2 = compare("multihot_bwd.dw", dw, rdw, bdw)
            if e2 / t2 > err / tol:
                err, tol = e2, t2
            ok = ok and ok2
        bwd_rows.append(dict(
            variant=desc + (" need_dw" if need_dw else " table-only"),
            max_abs_err=err, tol=tol, ok=ok,
            ms=cuda_ms(lambda: mh.multihot_bwd_cuda(tables, cols, ws, g, W,
                                                    need_dw)),
            plain_ms=cuda_ms(lambda: mh.multihot_bwd_plain(tables, cols, ws,
                                                           g, W, need_dw))))
    return fwd_rows, bwd_rows


KERNELS = [
    # name, C source, TPU kernel it replaces
    ("segment_add", "nvsf_torch/csrc/segsum.cu",
     "nvsf_tpu/ops/segsum.py:102"),
    ("multihot_fwd", "nvsf_torch/csrc/multihot.cu",
     "nvsf_tpu/ops/multihot.py:33"),
    ("multihot_bwd", "nvsf_torch/csrc/multihot.cu",
     "nvsf_tpu/ops/multihot.py:47"),
]


def phase_kernels():
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fwd, bwd = check_multihot(gen, dev)
    rows = {"segment_add": check_segment_add(gen, dev),
            "multihot_fwd": fwd, "multihot_bwd": bwd}
    bad = []
    for name, rs in rows.items():
        for r in rs:
            log("kernels", f"{name} [{r['variant']}]: max_abs_err "
                           f"{r['max_abs_err']:.3e} (tol {r['tol']:.3e}) "
                           f"kernel {r['ms']:.4f} ms, plain "
                           f"{r['plain_ms']:.4f} ms"
                           + ("" if r["ok"] else "  FAILED"))
            if not r["ok"]:
                bad.append(f"{name}[{r['variant']}]")
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return rows


# ----------------------------------------------------------------------
# phase 4: the joint training step at full width
# ----------------------------------------------------------------------

def joint_tuned_config(spec):
    """bench.py's "joint-tuned" rung: 2048 LiDAR + 2048 camera rays, 768
    candidates compacted to K = 96 (LiDAR) / 128 (camera), flow and URF
    losses, bf16 compute, the shipped encoder widths of
    configs/kitti360_1908.txt."""
    s = spec.scale
    return NVSFConfig.from_dict(dict(
        enable_lidar=True, enable_rgb=True, num_frames=spec.num_frames,
        scale=s, bound=1.0, min_near_lidar=1.0 * s,
        lidar_max_depth=80.0 * s, min_near=1.0 * s, active_sensor=True,
        num_rays=2048, num_rays_lidar=2048, num_steps=768,
        max_ray_batch=4096, iters=1000, epochs=1, use_error_map=True,
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


def _time_steps(tr, patch, n=8, warmup=2):
    """Medians over ``n`` steps of (wall ms of the synchronised step, host
    ms until ``train_step`` returns). The step never synchronises with
    the card, so the second is the host's dispatch of its kernels; when it
    is close to the first, the host bounds the step."""
    wall, host = [], []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(i % len(tr.scene), patch)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert np.isfinite(float(m["loss"]))
        if i >= warmup:
            wall.append((t2 - t0) * 1e3)
            host.append((t1 - t0) * 1e3)
    return float(np.median(wall)), float(np.median(host))


def check_against_cpu(field):
    """The trained field's density and its parameter gradients on 4096
    points, on the card (through the kernels) and on the CPU (through the
    plain versions), in f32. Table-gradient updates are summed unrounded
    here: rounding to bf16 turns a last-bit difference between the two
    devices' matmuls into a whole bf16 step (phase 3 checks the rounding
    variant against its plain version on identical inputs)."""
    import copy
    gen = torch.Generator().manual_seed(1)
    x = torch.rand((4096, 3), generator=gen) * 1.6 - 0.8
    c1 = torch.randn(4096, generator=gen)
    c2 = torch.randn((4096, field.spec.geo_feat_dim), generator=gen)
    results = []
    for dev in ("cuda", "cpu"):
        f = copy.deepcopy(field).to(dev)
        f.table_grad_precision = "f32"
        o = f.density(x.to(dev), 0.4, cal_lidar_color=True)
        ((o["sigma"] * c1.to(dev)).sum()
         + (o["geo_feat"] * c2.to(dev)).sum()).backward()
        results.append((o["sigma"].detach().cpu(),
                        {k: p.grad.detach().cpu() if p.grad is not None
                         else torch.zeros(p.shape)
                         for k, p in f.named_parameters()}))
    (sg, gg), (sc, gc) = results
    err = float(((sg - sc).abs() / sc.abs().clamp_min(1e-6)).max())
    assert err < 1e-3, f"density on the card vs CPU: rel err {err:.3e}"
    rel = {k: float((gg[k] - gc[k]).abs().max())
           / max(float(gc[k].abs().max()), 1e-12) for k in gc}
    worst = max(rel, key=rel.get)
    assert rel[worst] < 1e-3, \
        f"gradients on the card vs CPU: {worst} {rel[worst]:.3e}"
    return err, worst, rel[worst]


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


def profile_steps(tr, patch, n=3):
    """Device time per step by kernel family (torch.profiler): ({family:
    ms}, kernels per step)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n):
            tr.train_step(i % len(tr.scene), patch)
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
    launches = dict(kernels.LAUNCHES)
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
    missing = [k for k, v in launches.items() if v == 0]
    assert not missing, f"kernels not launched by the step: {missing}"

    rays = cfg.num_rays_lidar + cfg.num_rays
    for patch in (False, True):
        kind = "patch" if patch else "random"
        runs = []
        for rnd in (1, 2):      # back to back: the spread within one call
            ms, host_ms = _time_steps(tr, patch)
            runs.append(ms)
            log("slice", f"steady-state {kind} step, round {rnd}: {ms:.1f} "
                         f"ms = {rays / ms * 1e3:.0f} rays/s; host returns "
                         f"after {host_ms:.1f} ms ({smi})")
        ms = float(np.median(runs))
        fams, per_step = profile_steps(tr, patch)
        busy = sum(fams.values())
        log("profile", f"{kind} step: device time {busy:.1f} ms in "
                       f"{per_step} kernels; busy share "
                       f"{busy / ms:.2f} of the unprofiled step")
        for f, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
            log("profile", f"  {kind} {f:22s} {ms:8.2f} ms/step")
    err, worst, gerr = check_against_cpu(tr.field)
    log("slice", f"trained field on the card vs the CPU plain path: "
                 f"density rel err {err:.2e}, worst gradient {worst} "
                 f"{gerr:.2e} of its max (tol 1e-3)")
    return launches


# ----------------------------------------------------------------------
# phase 5: the convergence drive of .claude/skills/verify/SKILL.md
# ----------------------------------------------------------------------

def phase_learning():
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
        num_steps_occ=32, render_mode="occupancy", log2_hashmap_size=14,
        n_levels_hash=4, n_features_per_level_hash=8, flow_n_levels=4,
        iters=100, epochs=12, use_error_map=True))
    tr = Trainer(cfg, make_synthetic_scene(spec, split="train"),
                 device="cuda")
    losses = [tr.train_one_epoch().loss for _ in range(12)]
    log("learning", "epoch losses " + " ".join(f"{v:.3f}" for v in losses))
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < 0.7 * losses[0], \
        f"last loss {losses[-1]:.4f} not below 0.7 x first {losses[0]:.4f}"


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    rows = phase_kernels()
    launches = phase_slice(smi)
    phase_learning()
    record = []
    for name, source, replaces in KERNELS:
        rs = rows[name]
        worst = max(rs, key=lambda r: r["max_abs_err"] / r["tol"])
        record.append(dict(name=name, route="cuda", source=source,
                           replaces=replaces, launches=launches[name],
                           max_abs_err=worst["max_abs_err"],
                           ms=rs[0]["ms"], plain_ms=rs[0]["plain_ms"],
                           variants=rs))
    print(smi)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
