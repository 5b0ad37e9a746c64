"""Tiny CPU passes of both mixes through the harness, the frozen reference
held to nvsf_torch at a tiny size, the imports of a run, the control and
the faults the check has to catch."""

from __future__ import annotations

import subprocess
import sys
import textwrap

import pytest
import torch

from perfbench import harness
from perfbench.reference import model as M
from perfbench.tests.conftest import tiny_config, tiny_run

TRAIN = "train.kitti360-1908-occ"
DENSE = "train.kitti360-1908-ref"
RENDER = "render-lidar.kitti360-1908-occ"


@pytest.mark.parametrize("workload", [TRAIN, DENSE, RENDER])
def test_tiny_cpu_pass(workload):
    res, run = tiny_run(workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in harness.cell_metrics(
        harness.manifest(), workload, "end_to_end")}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


def test_tiny_cpu_traced_pass_reads_no_device_metric():
    res, run = tiny_run(RENDER, trace=True)
    assert res["correct"]
    # no device on the CPU: the trace's readers find nothing
    assert set(res["metrics"]) <= {"slabs_run_share.render"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res


@pytest.mark.parametrize("workload", [TRAIN, DENSE, RENDER])
def test_reference_agrees_with_the_program_in_f32(workload):
    """With the program in float32 the reference follows it to rounding:
    the same draws, losses, error maps, gradients, changes and EMA over
    random and patch steps, and the same frames."""
    from perfbench import check, control
    res, run = tiny_run(workload, f32=True)
    if workload == RENDER:
        nums = check.numbers(run, list(check.frame_numbers(run.c)))
        assert nums["depth_gap_m"] < 1e-3 and nums["raydrop_gap"] < 1e-5
        assert nums["intensity_gap"] < 1e-5
        return
    nums = check.numbers(run, list(check.TRAIN))
    assert all(v < 1e-4 for v in nums.values()), nums
    prog, ref = run.compared["other"], run.compared["reference"]
    extra = control.EXTRA()
    for k in ("loss_gap", "change_gap", "ema_gap"):
        assert extra[k](prog, ref) < 1e-4, (k, extra[k](prog, ref))
    # the checked steps hold both modes, and the patch step its grad loss
    assert [p for _, p in run.out["train"]["steps"]] == [False] * 3 + \
        [True] * 3
    last = max(ref["parts"])
    assert sorted(ref["parts"]) == [0, 2, 5]
    assert ref["parts"][last]["loss_sr"] > 0
    assert abs(prog["parts"][last]["loss_sr"] - ref["parts"][last]["loss_sr"]) \
        < 1e-4 * ref["parts"][last]["loss_sr"]


def test_reference_parameters_and_density_match_the_program():
    from nvsf_torch.models.field import NVSFField
    from nvsf_torch.train.trainer import field_spec_from_config
    from nvsf_torch.config import NVSFConfig
    man = harness.manifest()
    c = harness.run_config(tiny_config(harness.config_file(
        man, "kitti360-1908-occ")))
    field = NVSFField(field_spec_from_config(NVSFConfig.from_dict(c)))
    shapes = M.param_shapes(c)
    assert list(shapes) == [k for k, _ in field.named_parameters()]
    assert all(tuple(p.shape) == shapes[k]
               for k, p in field.named_parameters())
    P = M.init_params(c, 5, "cpu")
    with torch.no_grad():
        for k, p in field.named_parameters():
            p.copy_(P[k])
    g = torch.Generator().manual_seed(0)
    x = torch.rand((300, 3), generator=g) * 2 * c["bound"] - c["bound"]
    t = torch.tensor(0.4)
    for lidar in (True, False):
        got = field.density(x, t, cal_lidar_color=lidar)
        s, geo = M.density(P, c, x, t, lidar, M.f32_mm)
        torch.testing.assert_close(got["sigma"], s, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got["geo_feat"], geo, rtol=1e-5,
                                   atol=1e-6)


def test_run_imports_no_jax_and_reference_no_program():
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(harness.ROOT)!r})
        import perfbench.reference.model, perfbench.reference.step
        assert not any(m.split('.')[0] == 'nvsf_torch' for m in sys.modules)
        from perfbench.tests.conftest import tiny_run
        for w in ({TRAIN!r}, {RENDER!r}):
            tiny_run(w, trace=True)
        from perfbench import run, control
        for name in ("idle_share.train", "mfu.render"):
            from perfbench import harness
            harness.metric_reader(name)
        tops = {{m.split('.')[0] for m in sys.modules}}
        bad = tops & {{'jax', 'jaxlib', 'flax', 'nvsf_tpu'}}
        assert not bad, bad
        assert run.forbidden_modules() == []
        print('ok')
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    from perfbench import run
    monkeypatch.setitem(sys.modules, "nvsf_tpu_other", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert run.forbidden_modules() == ["jaxlib"]


# ----------------------------------------------------------------------
# the control and the faults: the check has to come out false
# ----------------------------------------------------------------------

@pytest.mark.parametrize("workload", [TRAIN, RENDER])
def test_control_reads_above_the_program(workload):
    """The float8 reference put in the program's place comes out not
    correct under the configuration's limits."""
    from perfbench import check, control
    res, run = tiny_run(workload)
    assert res["correct"], res["checks"]
    steps, frame = control.others(run, "control")
    ok, rows = check.check(run, steps, frame)
    assert not ok, rows


def test_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, *a, **k: None)
    res, _ = tiny_run(TRAIN)
    assert not res["correct"]


def test_fault_half_of_the_batch(monkeypatch):
    from nvsf_torch.train import losses

    def halve(fn):
        def f(p, g):
            out = fn(p, g)
            keep = torch.zeros(out.shape[0])
            keep[:out.shape[0] // 2] = 2.0
            return out * keep.reshape(-1, *([1] * (out.dim() - 1)))
        return f
    monkeypatch.setattr(losses, "mse", halve(losses.mse))
    monkeypatch.setattr(losses, "l1", halve(losses.l1))
    res, _ = tiny_run(TRAIN)
    assert not res["correct"]


def test_fault_frame_altered(monkeypatch):
    from nvsf_torch.train.trainer import Trainer
    orig = Trainer.render_lidar_frame

    def altered(self, fi, use_ema=False):
        out = orig(self, fi, use_ema)
        out["depth"] = out["depth"] * 1.5
        return out
    monkeypatch.setattr(Trainer, "render_lidar_frame", altered)
    res, _ = tiny_run(RENDER)
    assert not res["correct"]
    assert res["checks"]["depth_gap_m"]["value"] > \
        res["checks"]["depth_gap_m"]["limit"]


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short run of the shipped training cell on the card."""
    out = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload", TRAIN,
         "--seed", "4000000001", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
