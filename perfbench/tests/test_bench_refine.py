"""The U-Net refine cell (``refine.kitti360-1908-unet``): its readers on a
hand-made traced window, a window without the U-Net's markers (the parent
of the change that added them) read as nothing by the span readers, and a
tiny CPU run of the entry through ``run.execute``: correct against its
float32 reference, its control and its planted fault read apart from the
program, and a window of eager steps counted whole."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from perfbench import control, harness
from perfbench import run as runmod
from perfbench import unet_counts as uc
from perfbench.tests.conftest import tiny_config

CELL = "refine.kitti360-1908-unet"
READERS = ["unet_ms.refine", "optim_ms.refine", "mfu.refine",
           "conv_roofline.refine", "idle_share.refine"]
U = {"in_channels": 3, "channels": 32, "out_channels": 1, "dropout": 0.1,
     "num_heads": 8}


def _op(name, start, dur):
    return (name, float(start), float(dur))


def _window(markers=True):
    """Two refine steps' device ops (count 2): the box mask in ``loss``,
    zero-grad in ``optim``, the U-Net's spans (a forward convolution in
    each), the BCE in ``loss``, the backward holding the U-Net's spans
    again (an input and a weight gradient), Adam in ``optim``."""
    body = [("loss", [("mask_kernel", 3)]), ("optim", [("zero_kernel", 1)]),
            ("unet.down", [("sm90_xmma_fprop_implicit_gemm_tf32", 40)]),
            ("unet.attn", [("gemm_kernel", 2)]),
            ("unet.up", [("sm90_xmma_fprop_implicit_gemm_tf32", 50)]),
            ("loss", [("bce_kernel", 4)]),
            ("backward", [("glue_kernel", 1),
                          ("unet.up", [("sm90_xmma_dgrad_x", 60),
                                       ("sm90_xmma_wgrad_x", 30)]),
                          ("unet.down", [("cutlass_Wgrad_y", 20)])]),
            ("optim", [("adam_kernel", 5)])]
    ops, t = [], 0.0

    def emit(span, items):
        nonlocal t
        ident = span.replace(".", "_")
        if markers:
            ops.append(_op(f"nvsf_span_open_{ident}", t, 1))
            t += 1
        for name, d in items:
            if isinstance(d, list):
                emit(name, d)
            else:
                ops.append(_op(name, t, d))
                t += d
        if markers:
            ops.append(_op(f"nvsf_span_close_{ident}", t, 1))
            t += 1
    for _ in range(2):
        for span, items in body:
            emit(span, items)
    w = SimpleNamespace(device_ops=ops, host_ops=[], kernels=list(ops),
                        busy_s=t / 1e6, wall_s=2 * t / 1e6)
    return SimpleNamespace(
        trace_data=w, mix={"entry": "refine"}, work={"count": 2},
        cfg_file={"unet": U},
        out={"refine": {"x": SimpleNamespace(shape=(64, 3, 66, 1030))}})


def _read(name, run):
    return harness.metric_reader(name)(run)


def test_readers_on_a_refine_window():
    run = _window()
    # per step (two in the window): each span's ops and its two markers,
    # the U-Net's three forward spans and two in the backward
    assert _read("unet_ms.refine", run) == pytest.approx(
        ((40 + 2) + (2 + 2) + (50 + 2) + (60 + 30 + 2) + (20 + 2)) / 1e3)
    assert _read("optim_ms.refine", run) == pytest.approx(
        (1 + 2 + 5 + 2) / 1e3)
    w = run.trace_data
    assert _read("idle_share.refine", run) == pytest.approx(50.0)
    step = uc.step_flops(U, 64, 66, 1030)
    assert _read("mfu.refine", run) == pytest.approx(
        100 * 2 * step / (w.wall_s * uc.TF32_FLOP_PER_S))
    conv_s = (40 + 50 + 60 + 30 + 20) * 2 / 1e6
    assert _read("conv_roofline.refine", run) == pytest.approx(
        100 * 2 * uc.conv_bound_s(U, 64, 66, 1030) / conv_s)


def test_span_readers_read_nothing_without_markers():
    """The program before the U-Net's spans launches none in the refine
    step: the span readers leave their metrics out, the others read."""
    run = _window(markers=False)
    assert _read("unet_ms.refine", run) is None
    assert _read("optim_ms.refine", run) is None
    assert all(_read(n, run) is not None for n in
               ("mfu.refine", "conv_roofline.refine", "idle_share.refine"))


def test_readers_read_only_refine_windows():
    run = _window()
    run.mix = {"entry": "train"}
    assert all(_read(n, run) is None for n in READERS)


def test_counts():
    """Section by section, the published U-Net's work at [64, 3, 66,
    1030]: 32.2 GFLOP a frame forward, the decoder's 3x3 convolutions
    25.9 of them; a step's convolution calls, forward, input and weight
    gradients (none for the in-conv's input), bound by the TF32 rate."""
    convs = uc.convs(U, 66, 1030)
    assert len(convs) == 20
    assert uc.forward_flops(U, 1, 66, 1030) / 1e9 == pytest.approx(
        32.22, abs=0.01)
    up = sum(2 * a * b * k * k * p for n, a, b, k, p in convs
             if n.startswith("up"))
    assert up / 1e9 == pytest.approx(25.89, abs=0.01)
    calls = uc.conv_calls(U, 64, 66, 1030)
    assert len(calls) == 3 * 20 - 1
    assert uc.step_flops(U, 64, 66, 1030) == 3 * uc.forward_flops(
        U, 64, 66, 1030)
    # up1's 512-wide 3x3 convolution is bound by the TF32 rate, up4's
    # 64-wide one at full size by its bytes
    calls = {n: (b, f) for n, b, f in calls}
    b, f = calls["up1.conv1.fprop"]
    assert uc.bound_s(b, f) == pytest.approx(f / uc.TF32_FLOP_PER_S)
    b, f = calls["up4.conv1.fprop"]
    assert uc.bound_s(b, f) == pytest.approx(b / 3.35e12)


@pytest.fixture(scope="module")
def tiny():
    """(result, the Run) of one tiny CPU run of the cell: 8 frames of 34 x
    66 (a U-Net needs sides of 16 and more; 34 and 66 pad as 66 and 1030
    do), the batch every frame."""
    man = harness.manifest()
    cell = harness.cell(man, CELL)
    cfg = tiny_config(harness.config_file(man, cell["config"]))
    cfg["scene"]["lidar_hw"] = [34, 66]
    cfg["refine"]["batch"] = cfg["scene"]["num_frames"]
    captured = {}
    orig = harness.Run.release

    def release(self):
        captured["run"] = self
        return orig(self)
    harness.Run.release = release
    try:
        res = runmod.execute(
            cfg, harness.traffic_file(cell["traffic"]),
            harness.limits_file(CELL),
            harness.cell_metrics(man, CELL, "end_to_end"),
            harness.cell_metrics(man, CELL, "per_layer"), 2 ** 31 + 23, 0.3,
            False, "cpu", 1, time.perf_counter())
    finally:
        harness.Run.release = orig
    return res, captured["run"]


def test_tiny_run_is_correct(tiny):
    res, run = tiny
    assert res["correct"], res["checks"]
    # whole units of 10 steps, none failed; the program freed before the
    # reference ran
    assert res["attempted"] >= 10 and res["attempted"] % 10 == 0
    assert res["failed"] == 0 and run.refine is None
    assert set(res["metrics"]) == {"train_rays_per_s", "setup_s"}
    B, _, H, W = run.out["refine"]["x"].shape
    assert (B, H, W) == (8, 34, 66)
    assert res["metrics"]["train_rays_per_s"]["value"] == pytest.approx(
        res["attempted"] * B * H * W / run.work["wall_s"])
    assert len(run.out["refine"]["steps"]) == 3
    assert run.refine_next == 3 + 10 * (1 + res["attempted"] // 10)


def test_control_and_fault_read_apart_from_the_program(tiny):
    _, run = tiny
    prog = control.readings(run, "program")["numbers"]
    for side in ("control", "fault_align"):
        other = control.readings(run, side)["numbers"]
        assert set(other) == set(prog)
        # the program follows the float32 reference to rounding here; a
        # side moves the output and the gradients by far more
        assert other["out_gap"] > 100 * prog["out_gap"], side
        assert other["grad_gap"] > 10 * prog["grad_gap"], side
    with pytest.raises(ValueError, match="not one of the entry's sides"):
        control.readings(run, "fault_half")


def test_an_unchanged_state_reads_one(tiny):
    """``change_gap_median`` holds the program's parameters after each
    checked step to the reference's own step: the program reads rounding
    here, a step that left the parameters unchanged reads 1."""
    _, run = tiny
    e = run.module
    states = run.out["refine"]["states"]
    assert e.numbers(run, ["change_gap_median"])["change_gap_median"] < 1e-3
    still = [dict(o, params=s["params"])
             for o, s in zip(run.out["refine"]["steps"], states)]
    assert max(e._change_gap_median(o, r, s) for o, r, s in zip(
        still, e._computed(run, "reference"), states)) == pytest.approx(1.0)


def test_grad_gap_holds_each_parameter_to_its_own_gradient(tiny):
    """A parameter whose gradient is a hundredth of the others' is held
    to its own norm; one within float32's rounding of zero on both sides
    reads nothing."""
    import torch
    e = tiny[1].module
    r = {"grads": {"big": torch.ones(4), "small": torch.full((4,), 0.01),
                   "zero": torch.zeros(4)}}
    o = {"grads": {"big": torch.ones(4), "small": torch.full((4,), 0.015),
                   "zero": torch.full((4,), 1e-12)}}
    assert e._grad_gap(o, r, None) == pytest.approx(0.5)
    o["grads"]["small"] = r["grads"]["small"]
    assert e._grad_gap(o, r, None) < 1e-5


def test_a_unet_of_other_widths_is_refused(tiny):
    _, run = tiny
    from nvsf_torch.models.unet import UNet
    run.tr = SimpleNamespace(unet=UNet(channels=16))
    with pytest.raises(ValueError, match="the configuration states"):
        run.module.setup(run)
