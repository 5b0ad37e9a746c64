"""A traffic entry added as new files alone. A copy of ``perfbench/`` gains
an entry module that drives the built program (the EMA field's density at
seeded points, through ``run.tr``), its plain reference, a configuration,
a mix, limits and a span-reading metric reader, and entries in a copy of
``BENCHMARK.json``. The copy's own harness, imported in a process of its
own, runs the entry through ``run.execute`` to ``correct``, a planted fault
to not correct, and no file that was there changes."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import textwrap

import pytest

from perfbench import harness

ROOT = harness.ROOT
CELL = "density.new-config"

ENTRY = '''
"""The EMA field's density at the mix's seeded points, through the
program's ``Trainer``: a unit is one query of them all."""

import numpy as np
import torch

NUMBERS = ("sigma_gap",)
SIDES = ("scaled",)


def setup(run):
    x = run.rng.uniform(-1.0, 1.0, (run.mix["points"], 3)) * run.c["bound"]
    run.query = (torch.tensor(x, dtype=torch.float32, device=run.device),
                 torch.tensor(float(run.rng.uniform()), device=run.device))
    run.out["density_query"] = {}
    for _ in range(run.mix["warmup_units"]):
        unit(run)


def unit(run):
    x, t = run.query
    with torch.no_grad():
        sigma = run.tr.ema_field.density(x, t)["sigma"]
    run.failed += int(not bool(torch.isfinite(sigma).all()))
    run.out["density_query"] = {"x": x, "t": t, "sigma": sigma}
    return 1


def measures(run):
    return {"query_points_per_s": run.work["count"] * run.mix["points"]
            / run.work["wall_s"]}


def numbers(run, names, side="program"):
    from perfbench.reference import density_query as ref
    out = run.out["density_query"]
    r = ref.sigma(run.c, run.seeds.weights, out["x"], out["t"])
    p = 1.5 * r if side == "scaled" else out["sigma"]
    gap = float((p - r).abs().mean() / r.abs().mean())
    return {"sigma_gap": gap}
'''

REFERENCE = '''
"""The field's density from the seed's weights, plain float32."""

import torch

from perfbench.reference import model as M


def sigma(c, weights_seed, x, t):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = M.init_params(c, weights_seed, x.device)
    return M.density(P, c, x, t, False, M.f32_mm)[0]
'''

READER = '''
"""Spans the program opened a unit in the traced window: its markers,
kernels on the card or host ranges on the CPU."""

import re

OPEN = re.compile(r"nvsf_span[_:]open[_:]")


def read(run):
    w = run.trace_data
    if w is None or not run.work["count"]:
        return None
    n = sum(1 for name, _, _ in w.device_ops + w.host_ops
            if OPEN.search(name))
    return n / run.work["count"] if n else None
'''

DRIVE = '''
import json, sys
sys.path[:0] = [{copy!r}, {repo!r}]
from perfbench import control, harness
from perfbench.tests.conftest import tiny_run
from perfbench.tests.test_bench_manifest import check_limits_readable
assert str(harness.HERE).startswith({copy!r}), harness.HERE
check_limits_readable(harness.manifest())
out = {{}}
out["plain"], run = tiny_run({cell!r})
out["sides"] = {{side: control.readings(run, side)["numbers"]
                for side in ("program",) + run.module.SIDES}}
try:
    control.readings(run, "no_such_side")
except ValueError as e:
    out["unnamed_side"] = str(e)
out["traced"], _ = tiny_run({cell!r}, trace=True)
from nvsf_torch.models.field import NVSFField
orig = NVSFField.density


def altered(self, *a, **k):
    d = orig(self, *a, **k)
    d["sigma"] = 1.5 * d["sigma"]
    return d


NVSFField.density = altered
out["fault"], _ = tiny_run({cell!r})
print("RESULT " + json.dumps(out))
'''


@pytest.fixture(scope="module")
def copied(tmp_path_factory):
    """(root of the copy, its files' bytes before the new ones)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "perfbench").rglob("*") if p.is_file()}
    base = root / "perfbench"
    man = harness.manifest()
    (base / "entries" / "density_query.py").write_text(ENTRY)
    (base / "reference" / "density_query.py").write_text(REFERENCE)
    (base / "metrics" / "span_opens.density.py").write_text(READER)
    cfg = json.loads((ROOT / man["configs"][0]["file"]).read_text())
    cfg["name"] = "new-config"
    (base / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (base / "traffic" / "density-points.json").write_text(json.dumps(
        {"entry": "density_query", "points": 512, "warmup_units": 1,
         "trace_units": 2, "why": "a test mix"}))
    (base / "limits" / f"{CELL}.json").write_text(json.dumps(
        {"sigma_gap": 1e-4}))
    new = dict(man)
    new["configs"] = man["configs"] + [dict(
        man["configs"][0], name="new-config",
        file="perfbench/configs/new-config.json")]
    new["workloads"] = man["workloads"] + [
        {"name": CELL, "config": "new-config", "traffic": "density-points",
         "chips": 1, "why": "a test cell"}]
    new["end_to_end"] = man["end_to_end"] + [
        {"name": "query_points_per_s", "unit": "points/s",
         "better": "higher", "bound": 0.05, "source": "host_clock",
         "workloads": [CELL]}]
    new["per_layer"] = man["per_layer"] + [
        {"name": "span_opens.density", "unit": "spans", "better": "lower",
         "source": "program_span", "layer": "field",
         "moves": "query_points_per_s", "workloads": [CELL]}]
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    return root, before


@pytest.fixture(scope="module")
def ran(copied):
    """The copy's harness driving the new entry: a run, the module's
    sides read by ``control.readings``, a traced run, and a run with a
    fault planted in the program."""
    root = copied[0]
    code = DRIVE.format(copy=str(root), repo=str(ROOT), cell=CELL)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, timeout=900,
                         cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def test_new_entry_runs_to_correct(ran):
    res = ran["plain"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"query_points_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["checks"]["sigma_gap"]["limit"] == 1e-4


def test_new_entry_traced_window_reads_its_metric(ran):
    res = ran["traced"]
    assert res["correct"], res["checks"]
    # a density query opens the hash, plane and MLP spans at least
    assert res["metrics"]["span_opens.density"]["value"] >= 3
    assert res["attempted"] == 2 and res["device"]["window_s"] > 0


def test_planted_fault_is_not_correct(ran):
    res = ran["fault"]
    assert not res["correct"]
    assert res["checks"]["sigma_gap"]["value"] > 0.1


def test_entry_sides_are_read_in_the_programs_place(ran):
    sides = ran["sides"]
    assert sides["program"]["sigma_gap"] < 1e-4
    assert sides["scaled"]["sigma_gap"] == pytest.approx(0.5, rel=1e-5)


def test_a_side_the_entry_does_not_name_is_refused(ran):
    assert "'no_such_side' is not one of the entry's sides" \
        in ran.get("unnamed_side", "")


def test_no_existing_file_changed(copied, ran):
    root, before = copied
    assert all((root / k).read_bytes() == v for k, v in before.items())


def test_an_entry_with_no_module_names_the_known(copied):
    root, _ = copied
    with pytest.raises(ValueError, match="unknown traffic entry") as err:
        harness.entry_module("no_entry_is_named_so", root / "perfbench")
    known = set(str(err.value).rsplit("known: ", 1)[1].split(", "))
    assert {"train", "render_lidar", "density_query"} <= known
