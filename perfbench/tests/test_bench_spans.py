"""The span readers (``perfbench/spans.py`` and the ``*_ms`` /
``dispatch_us`` metrics) on a hand-made traced window: nesting, a span
re-opened in the backward, ops before the first marker outside every
span, the refresh apart from the step's modules, and nothing read from a
window without markers (a program that launches none)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from perfbench import harness, spans

NAMES = ["encode_ms.train", "mlp_ms.train", "render_ms.train",
         "loss_ms.train", "optim_ms.train", "refresh_ms.train",
         "dispatch_us.train"]


def _op(name, start, dur):
    return (name, float(start), float(dur))


def _marks(span, start, body, dur=1.0):
    """open marker, the body's ops, close marker; returns (ops, end)."""
    ident = span.replace(".", "_")
    ops = [_op(f"nvsf_span_open_{ident}", start, dur)]
    t = start + dur
    for name, d in body:
        if isinstance(name, tuple):         # a nested span
            inner, t = _marks(name[0], t, name[1])
            ops += inner
        else:
            ops.append(_op(name, t, d))
            t += d
    ops.append(_op(f"nvsf_span_close_{ident}", t, dur))
    return ops, t + dur


def _window():
    """Two steps' worth of device ops (count 2): a kernel before any
    marker; sample; render holding an encode.hash and an mlp; a loss;
    the backward re-opening encode.hash (B1 inside it); optim; a refresh
    whose field queries are encode.hash and mlp spans."""
    ops = [_op("elementwise_kernel_pre", 0, 10)]
    t = 10.0
    for span, body in (
            ("sample", [("index_kernel", 20)]),
            ("render", [("compact_kernel", 30),
                        (("encode.hash", [("multihot_fwd_kernel", 40)]),
                         None),
                        (("mlp", [("gemm_kernel", 50)]), None)]),
            ("loss", [("loss_kernel", 60)]),
            ("backward", [("glue_kernel", 5),
                          (("encode.hash",
                            [("segment_add_rows_kernel", 70)]), None)]),
            ("optim", [("adam_kernel", 80)]),
            ("refresh", [(("encode.hash", [("multihot_fwd_kernel", 90)]),
                          None),
                         (("mlp", [("gemm_kernel", 100)]), None),
                         ("scatter_kernel", 110)])):
        more, t = _marks(span, t, body)
        ops += more
    host = [("nvsf/step.dispatch", 0.0, 30.0),
            ("nvsf/step.dispatch", 100.0, 34.0),
            ("nvsf/epoch.sums", 40.0, 6.0),
            ("nvsf/train epoch", 0.0, 1000.0)]
    w = SimpleNamespace(device_ops=ops, host_ops=host,
                        kernels=[o for o in ops])
    return SimpleNamespace(trace_data=w, mix={"entry": "train"},
                           work={"count": 2})


def _read(name, run):
    return harness.metric_reader(name)(run)


def test_readers_charge_the_innermost_span_a_step():
    run = _window()
    # a marker is charged to its own span; two steps in the window
    assert _read("encode_ms.train", run) == pytest.approx(
        (2 + 40 + 2 + 70) / 2e3)
    assert _read("mlp_ms.train", run) == pytest.approx((2 + 50) / 2e3)
    assert _read("render_ms.train", run) == pytest.approx(
        (2 + 20 + 2 + 30) / 2e3)
    assert _read("loss_ms.train", run) == pytest.approx((2 + 60) / 2e3)
    assert _read("optim_ms.train", run) == pytest.approx((2 + 80) / 2e3)
    # everything inside the refresh, its nested spans included
    assert _read("refresh_ms.train", run) == pytest.approx(
        (2 + 2 + 90 + 2 + 100 + 110) / 2e3)
    assert _read("dispatch_us.train", run) == pytest.approx(
        (30 + 34 + 6) / 2)


def test_dispatch_leaves_out_a_blocked_launch():
    """A replay's launch that waits on a full queue, the runtime calls
    nested in it and a synchronisation are the device's time: only the
    host's own work around them is dispatch."""
    run = _window()
    run.trace_data.host_ops = [
        ("nvsf/step.dispatch", 0.0, 5000.0),
        ("nvsf/step.replay", 10.0, 4980.0),
        ("cudaGraphLaunch", 20.0, 4900.0),
        ("Command Buffer Full", 25.0, 4890.0),
        ("nvsf/epoch.sums", 6000.0, 400.0),
        ("cudaLaunchKernel", 6100.0, 4.0),
        ("cudaStreamSynchronize", 6300.0, 300.0),   # runs past the range
        ("aten::add_", 6050.0, 30.0),
        ("nvsf/step.dispatch", 7000.0, 60.0),
        ("cudaGraphLaunch", 7010.0, 8.0),
        ("cudaMemcpyAsync", 9000.0, 50.0)]          # outside every range
    host = (5000 - 4900) + (400 - 4 - 100) + (60 - 8)
    assert _read("dispatch_us.train", run) == pytest.approx(host / 2)


def test_every_op_is_counted_once():
    """The modules, the refresh, the backward's glue and ``(none)`` add
    up to the window's device op time."""
    run = _window()
    total = sum(d for _, _, d in run.trace_data.device_ops)
    parts = sum(_read(n, run) for n in NAMES[:6]) * 2e3
    glue = spans.self_ms(run, ("backward",)) * 2e3
    before = sum(d for st, d in spans.walk(run.trace_data.device_ops)
                 if not st)
    assert before == 10
    assert parts + glue + before == pytest.approx(total)


def test_a_close_pops_back_to_its_open():
    """A close whose open is not innermost (an open left unclosed inside
    it) closes both; a close with no open is ignored."""
    ops = [_op("nvsf_span_open_render", 0, 1),
           _op("nvsf_span_open_mlp", 1, 1),
           _op("nvsf_span_close_render", 2, 1),
           _op("after", 3, 5),
           _op("nvsf_span_close_loss", 8, 1)]
    stacks = [st for st, _ in spans.walk(ops)]
    assert stacks == [("render",), ("render", "mlp"), ("render", "mlp"),
                      (), ()]


def test_a_window_of_another_entry_with_markers_is_read():
    """An entry module's window that ran the program's markers reads as a
    training window does: a new entry's span readers are new files."""
    run = _window()
    run.mix = {"entry": "density_query"}
    train = _window()
    assert all(_read(n, run) == pytest.approx(_read(n, train))
               for n in NAMES)
    assert _read("encode_ms.train", run) == pytest.approx(
        (2 + 40 + 2 + 70) / 2e3)


def test_a_window_without_markers_reads_nothing():
    run = _window()
    run.trace_data.device_ops = [o for o in run.trace_data.device_ops
                                 if "nvsf_span" not in o[0]]
    assert all(_read(n, run) is None for n in NAMES)
    run = _window()
    run.mix = {"entry": "render_lidar"}
    assert all(_read(n, run) is None for n in NAMES)
    man = harness.manifest()
    dense = [m for m in harness.cell_metrics(
        man, "train.kitti360-1908-ref", "per_layer") if "_ms." in m["name"]]
    assert {m["name"] for m in dense} == {
        f"{n}_ms.train-dense" for n in ("encode", "mlp", "render", "loss",
                                        "optim")}
    assert harness.per_layer(_window(), dense)["encode_ms.train-dense"][
        "value"] == pytest.approx(_read("encode_ms.train", _window()))
