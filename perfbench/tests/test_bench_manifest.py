"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a traffic mix and a metric added as new files."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
ROOT = harness.ROOT


@pytest.fixture(scope="module")
def man():
    return harness.manifest()


def test_top_level_keys(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["command"] == ["python3", "perfbench/run.py"]
    assert man["paths"] == ["perfbench"]
    assert 1 <= man["run_seconds"] <= 51
    assert len(json.dumps(man)) < 64 * 1024


def test_names_units_and_text(man):
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("perfbench/")
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and TEXT.match(w["why"])
        names.append(w["name"])
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    assert len({c["name"] for c in man["configs"]}) == len(man["configs"])
    assert len({w["name"] for w in man["workloads"]}) == len(man["workloads"])
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_cells(man):
    configs = {c["name"] for c in man["configs"]}
    pairs = set()
    for w in man["workloads"]:
        assert w["config"] in configs
        assert w["chips"] == 1, "no cell of this benchmark needs four chips"
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert configs == {w["config"] for w in man["workloads"]}


def test_metrics_and_moves(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in man["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert any(reports(m, cell) for m in man["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(reports(m, cell) for m in man["per_layer"])
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and TEXT.match(m["layer"])
        for cell in m.get("workloads", cells):
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] \
                or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_config_files(man):
    for c in man["configs"]:
        d = json.loads((ROOT / c["file"]).read_text())
        assert d["name"] == c["name"] and d["reduced"] == c["reduced"]
        for key in ("source", "nvsf", "scene", "assumed"):
            assert key in d


def check_limits_readable(man, base=harness.HERE):
    """Each cell's limits name only numbers the check reads for its entry:
    ``check.TRAIN``, the frame numbers, or an entry module's ``NUMBERS``."""
    from perfbench import check
    for w in man["workloads"]:
        lim = harness.limits_file(w["name"], base)
        entry = harness.traffic_file(w["traffic"], base)["entry"]
        if entry == "train":
            known = check.TRAIN
        elif entry == "render_lidar":
            known = check.frame_numbers(harness.run_config(
                harness.config_file(man, w["config"], base.parent)))
        else:
            known = harness.entry_module(entry, base).NUMBERS
        assert lim and set(lim) <= set(known), (w["name"], lim)
        assert all(v > 0 for v in lim.values())


def test_every_cell_has_limits_the_check_can_read(man):
    check_limits_readable(man)


def test_new_files_are_found_without_edits(tmp_path, man):
    """A later change adds a configuration, a mix and a metric as files
    and entries; the harness finds each by name."""
    shutil.copytree(harness.HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    base = tmp_path / "perfbench"
    cfg = json.loads((ROOT / man["configs"][0]["file"]).read_text())
    cfg["name"] = "new-config"
    (base / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (base / "traffic" / "new-mix.json").write_text(json.dumps(
        {"entry": "train", "frames_per_call": 2,
         "checked": [["random", 3], ["patch", 3]],
         "warmup_calls": 1, "trace_calls": 1}))
    (base / "limits" / "x.new.json").write_text(json.dumps(
        {"errmap_fit_gap": 0.01}))
    (base / "metrics" / "new_metric.train.py").write_text(
        "def read(run):\n    return 42.0\n")
    new = dict(man)
    new["configs"] = man["configs"] + [dict(
        man["configs"][0], name="new-config",
        file="perfbench/configs/new-config.json")]
    new["workloads"] = man["workloads"] + [
        {"name": "x.new", "config": "new-config", "traffic": "new-mix",
         "chips": 1, "why": "a test cell"}]
    new["per_layer"] = man["per_layer"] + [
        {"name": "new_metric.train", "unit": "%", "better": "higher",
         "source": "device_trace", "layer": "device",
         "moves": "train_rays_per_s", "workloads": ["x.new"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))

    m2 = harness.manifest(tmp_path)
    cell = harness.cell(m2, "x.new")
    assert harness.config_file(m2, cell["config"], tmp_path)["name"] == \
        "new-config"
    assert harness.traffic_file(cell["traffic"], base)["frames_per_call"] == 2
    layers = harness.cell_metrics(m2, "x.new", "per_layer")
    assert [m["name"] for m in layers] == ["new_metric.train"]
    assert harness.metric_reader("new_metric.train", base)(None) == 42.0
    assert harness.limits_file("x.new", base) == {"errmap_fit_gap": 0.01}
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
