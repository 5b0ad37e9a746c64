"""The training path's spans (``nvsf_torch/train/profiler.py``) on the
CPU, at toy size: an eager step of each mode, and a U-Net refine step,
under ``torch.profiler`` marks every span it runs, forward and backward,
balanced and nested; the host spans never wait for the device and record
only under a profiler; ``device_trace`` writes its reduction beside the
Chrome trace. The marker kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""

import json
import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nvsf_torch.config import NVSFConfig
from nvsf_torch.data.synthetic import SyntheticSceneSpec, make_synthetic_scene
from nvsf_torch.models.unet import UNet
from nvsf_torch.train import profiler as P
from nvsf_torch.train.refine import refine_steps
from nvsf_torch.train.trainer import Trainer

from test_torch_models import one_torch_thread  # noqa: F401

SPEC = dict(H_lidar=16, W_lidar=32, H=16, W=24, max_depth=80.0,
            scale=1.0 / 81.0)
FRAMES = 4
STEP_SPANS = {"sample", "render", "encode.hash", "encode.planes",
              "encode.flow", "mlp", "loss", "backward", "optim"}


def _trainer(**over):
    s = SPEC["scale"]
    d = dict(enable_lidar=True, enable_rgb=True, num_frames=FRAMES, scale=s,
             bound=1.0, min_near_lidar=s, lidar_max_depth=80 * s,
             min_near=s, active_sensor=True, num_rays=32, num_rays_lidar=32,
             num_steps=16, num_steps_occ=8, log2_hashmap_size=10,
             n_levels_hash=2, n_features_per_level_hash=4, flow_n_levels=2,
             flow_log2_hashmap_size=10, max_resolution=64,
             flow_max_resolution=64, iters=100, flow_loss=True,
             use_error_map=True)
    d.update(over)
    scene = make_synthetic_scene(SyntheticSceneSpec(num_frames=FRAMES,
                                                    **SPEC))
    return Trainer(NVSFConfig.from_dict(d), scene, device="cpu")


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return P.trace_events(prof)


def _markers(events):
    """(kind, span, spans open before it) of each host marker, in order."""
    marks = sorted((s, n.split(":")[1], n.split(":")[2])
                   for n, s, _, dev in events
                   if not dev and n.startswith("nvsf_span:"))
    stack, out = [], []
    for _, kind, name in marks:
        out.append((kind, name, tuple(stack)))
        if kind == "open":
            stack.append(name)
        else:
            assert stack and stack[-1] == name, (name, stack)
            stack.pop()
    assert not stack, stack
    return out


def _check_balanced(times, expected):
    assert expected <= set(times), sorted(times)
    for name in expected:
        assert times[name]["opens"] == times[name]["closes"] > 0, name
        assert times[name]["self_us"] > 0, name
    total = sum(v["self_us"] for v in times.values())
    assert all(v["inclusive_us"] <= total * (1 + 1e-9) for v in
               times.values())


def test_occupancy_step_marks_every_span_nested_and_balanced():
    """One eager occupancy epoch of one step and its refresh: every span,
    opened as often as closed, each close matching the innermost open;
    the encoders' backward opened inside ``backward`` and charged there;
    the refresh's field queries nested inside ``refresh``."""
    tr = _trainer(render_mode="occupancy", occ_grid_size=8,
                  occ_update_interval=1)
    events = _traced(lambda: tr.train_one_epoch(order=[0]))
    times = P.span_times(events)
    _check_balanced(times, STEP_SPANS | {"refresh"})
    marks = _markers(events)
    in_bwd = [(k, n, st) for k, n, st in marks if "backward" in st]
    assert {n for k, n, _ in in_bwd if k == "open"} >= {
        "encode.hash", "encode.planes", "encode.flow", "mlp", "render",
        "loss"}
    # the backward opens the modules newest first: the loss, then render
    opens = [n for k, n, st in in_bwd if k == "open" and len(st) == 1]
    assert opens[0] == "loss" and "render" in opens
    in_refresh = {n for k, n, st in marks if "refresh" in st}
    assert {"encode.hash", "encode.planes", "mlp"} <= in_refresh
    assert "encode.flow" not in in_refresh      # the refresh skips the warp


@pytest.mark.parametrize("chunks", [1, 2])
def test_dense_step_remat_recomputes_inside_the_backward(chunks):
    """A dense ``uniform`` step: with ``remat_chunks`` 2 each chunk's
    density query is recomputed inside the backward, so the backward
    opens ``encode.hash`` twice for each forward open (the recomputation
    and the backward proper), and once with one chunk; every marker nests
    and balances either way."""
    tr = _trainer(render_mode="uniform", remat_chunks=chunks)
    events = _traced(lambda: tr.train_one_epoch(order=[1]))
    _check_balanced(P.span_times(events), STEP_SPANS)
    marks = _markers(events)
    fwd = sum(1 for k, n, st in marks
              if k == "open" and n == "encode.hash" and "backward" not in st)
    bwd = sum(1 for k, n, st in marks
              if k == "open" and n == "encode.hash" and "backward" in st)
    assert fwd == 2 * chunks        # two branches
    assert bwd == (2 if chunks > 1 else 1) * fwd
    if chunks > 1:
        # the recomputation's forward markers nest inside a backward
        # span of the density query's module
        assert any(k == "open" and n == "encode.hash" and st[-1] == "mlp"
                   for k, n, st in marks if "backward" in st)


def test_refine_step_marks_its_spans_in_order():
    """One eager refine step of a small U-Net: the box mask (``loss``),
    zero-grad (``optim``), the U-Net's three spans, the BCE (``loss``),
    the backward (``backward``, reopening the loss's span and the U-Net's,
    newest first) and Adam (``optim``), in that order, nested and
    balanced."""
    g = torch.Generator().manual_seed(0)
    x = torch.rand((1, 3, 16, 32), generator=g)
    rs = refine_steps(UNet(channels=8, generator=g), x,
                      (x[:, :1] > 0.5).float(), steps=10, graphed=False)
    events = _traced(lambda: rs.run(0, 1))
    _check_balanced(P.span_times(events), {
        "loss", "optim", "backward", "unet.down", "unet.attn", "unet.up"})
    opens = [(n, st) for k, n, st in _markers(events) if k == "open"]
    bwd = ("backward",)
    assert opens == [("loss", ()), ("optim", ()), ("unet.down", ()),
                     ("unet.attn", ()), ("unet.up", ()), ("loss", ()),
                     ("backward", ()), ("loss", bwd), ("unet.up", bwd),
                     ("unet.attn", bwd), ("unet.down", bwd), ("optim", ())]


def test_span_times_charges_device_ops_inside_their_spans():
    """The card's reduction on a hand-made trace: ops charged to the
    innermost open span (a marker to its own span), ops before the first
    marker to ``(none)``, a span re-opened in the backward summed, the
    self times adding up to the device op time."""
    ev = [("op_a", 0, 5, True),
          ("nvsf_span_open_loss", 10, 1, True),
          ("op_b", 11, 7, True),
          ("nvsf_span_open_encode_hash", 20, 1, True),
          ("segment_add_rows_kernel", 21, 30, True),
          ("nvsf_span_close_encode_hash", 60, 1, True),
          ("nvsf_span_close_loss", 61, 1, True),
          ("nvsf_span_open_encode_hash", 70, 1, True),
          ("op_c", 71, 4, True),
          ("nvsf_span_close_encode_hash", 80, 1, True),
          ("cudaGraphLaunch", 0, 90, False)]
    t = P.span_times(ev)
    assert t["(none)"]["self_us"] == 5
    assert t["loss"]["self_us"] == 1 + 7 + 1
    assert t["loss"]["inclusive_us"] == 1 + 7 + 1 + 30 + 1 + 1
    assert t["encode.hash"]["self_us"] == 32 + 6
    assert t["encode.hash"]["opens"] == t["encode.hash"]["closes"] == 2
    assert sum(v["self_us"] for v in t.values()) == \
        sum(d for _, _, d, dev in ev if dev)


def test_host_spans_never_sync_and_record_only_under_a_profiler(
        monkeypatch):
    synced, made = [], []
    tm = P.PhaseTimers(sync=lambda: synced.append(1))
    rf = P._host_range

    def counted(name):
        made.append(name)
        return rf(name)
    monkeypatch.setattr(P, "_host_range", counted)
    for _ in range(3):
        with tm.span("step.dispatch"):
            pass
    assert tm.counts["step.dispatch"] == 3 and tm.totals["step.dispatch"] > 0
    assert not synced and not made
    assert "step.dispatch" in tm.report()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tm.phase("train epoch"):
            with tm.span("epoch.sums"):
                torch.ones(4).sum()
    assert len(synced) == 1 and made == ["nvsf/train epoch",
                                         "nvsf/epoch.sums"]
    # host ops, not user annotations (which the profiler echoes on the
    # device's timeline)
    ranges = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("nvsf/")}
    assert set(ranges) == {"nvsf/train epoch", "nvsf/epoch.sums"}
    assert not any(e.is_user_annotation() for e in ranges.values())
    assert tm.counts["epoch.sums"] == 1


def test_epoch_records_its_host_spans():
    tr = _trainer(render_mode="occupancy", occ_grid_size=8,
                  occ_update_interval=1)
    tr.train_one_epoch(order=[0, 2])
    c = tr.timers.counts
    assert c["step.dispatch"] == c["epoch.sums"] == 2
    assert c["ema"] == c["epoch.sync"] == 1 and c["refresh.dispatch"] == 2
    assert c["train epoch"] == 1


def test_device_trace_writes_the_span_times(tmp_path):
    tr = _trainer(render_mode="occupancy", occ_grid_size=8)
    with P.device_trace(str(tmp_path)):
        tr.train_step(0, False)
    assert list(tmp_path.glob("trace_*.json"))
    spans, = tmp_path.glob("spans_*.json")
    d = json.loads(spans.read_text())
    assert d["unit"] == "us" and STEP_SPANS <= set(d["spans"])


def test_spans_match_the_marker_kernels():
    """``SPANS`` in the order of ``csrc/spans.cu``'s marker table, each a
    name the marker kernels and the reduction spell alike."""
    src = (Path(P.__file__).parent.parent / "csrc" / "spans.cu").read_text()
    table = re.search(r"#define NVSF_SPANS\(X\)(.*?)\n\n", src, re.S)
    idents = re.findall(r"X\((\w+)\)", table.group(1))
    assert idents == [n.replace(".", "_") for n in P.SPANS]
    assert all(re.fullmatch(r"[a-z]+(\.[a-z]+)?", n) for n in P.SPANS)
