"""The benchmark harness: finds a cell's configuration, traffic mix, limits,
per-layer metrics and traffic entry by name, builds the program under test
(``nvsf_torch``'s ``Trainer``) on the scene and weights made from the seed,
drives the mix's entry (``train``: its checked start, then whole calls;
``render_lidar``: frames from the settled state the benchmark makes; any
other: its module's ``setup`` and units) through its warm-up and its
measured or traced window, and hands what the window produced to
``check.py``.

Everything that belongs to one configuration, mix, cell's limits, metric
or entry is a file of its own: ``configs/<name>.json``,
``traffic/<name>.json``, ``limits/<cell>.json``, ``metrics/<name>.py``,
``entries/<entry>.py`` (its contract: ``entries/__init__.py``), with the
entry's plain reference under ``reference/``. Adding one needs no edit
here.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import scene as scenes
from perfbench.reference import model as refmodel

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


# ----------------------------------------------------------------------
# discovery
# ----------------------------------------------------------------------

def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   + ", ".join(w["name"] for w in man["workloads"]))


def config_file(man: dict, name: str, root: Path = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_file(name: str, base: Path = HERE) -> dict:
    with open(base / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits_file(workload: str, base: Path = HERE) -> dict:
    """The cell's limits: {number: limit} (``check.py`` names the
    numbers)."""
    with open(base / "limits" / f"{workload}.json") as f:
        return json.load(f)


def metric_reader(name: str, base: Path = HERE):
    """``metrics/<name>.py``'s ``read`` function."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_module(name: str, base: Path = HERE):
    """``entries/<name>.py``, the module of a traffic entry other than
    ``train`` and ``render_lidar``; a ``ValueError`` naming the entries
    known where there is none."""
    found = sorted(p.stem for p in (base / "entries").glob("*.py")
                   if p.stem != "__init__")
    if name not in found:
        raise ValueError(f"unknown traffic entry {name!r}; known: "
                         + ", ".join(["train", "render_lidar"] + found))
    spec = importlib.util.spec_from_file_location(
        "perfbench_entry_" + name.replace(".", "_").replace("-", "_"),
        base / "entries" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(man: dict, workload: str, kind: str) -> List[dict]:
    """The end-to-end (``kind`` "end_to_end") or per-layer metrics the
    cell reports."""
    return [m for m in man[kind]
            if "workloads" not in m or workload in m["workloads"]]


# ----------------------------------------------------------------------
# seeds, scene, weights, the program
# ----------------------------------------------------------------------

@dataclasses.dataclass
class Seeds:
    weights: int
    trainer: int
    order: int

    @classmethod
    def of(cls, seed: int) -> "Seeds":
        s = np.random.SeedSequence(int(seed)).generate_state(3)
        return cls(*(int(v) for v in s))


def run_config(cfg_file: dict) -> dict:
    """The flat configuration both sides read: the file's ``nvsf`` keys,
    with the scene's frame count."""
    c = dict(cfg_file["nvsf"])
    c["num_frames"] = cfg_file["scene"]["num_frames"]
    return c


def build_program(c: dict, scene: dict, weights: Dict[str, torch.Tensor],
                  seed: int, device):
    """The program's ``Trainer`` on ``scene`` with ``weights`` loaded into
    its field and its EMA."""
    from nvsf_torch.config import NVSFConfig
    from nvsf_torch.data.dataset import SceneData
    from nvsf_torch.train.trainer import Trainer

    ws = os.path.join(tempfile.gettempdir(), "perfbench_workspace")
    cfg = NVSFConfig.from_dict({**c, "workspace": ws}).finalize(
        steps_per_epoch=c["num_frames"])
    H, W = scene["images"].shape[1:3]
    Hl, Wl = scene["panos"].shape[1:3]
    sd = SceneData(
        poses_lidar=scene["poses_lidar"], images_lidar=scene["panos"],
        H_lidar=Hl, W_lidar=Wl, intrinsics_lidar=scene["intrinsics_lidar"],
        intrinsics_hoz_lidar=scene["intrinsics_hoz_lidar"],
        poses=scene["poses"], images=scene["images"], image_depths=None,
        H=H, W=W, intrinsics=scene["intrinsics"], times=scene["times"],
        frame_ids=scene["frame_ids"], num_frames=c["num_frames"],
        split="train")
    tr = Trainer(cfg, sd, seed=seed, device=device)
    with torch.no_grad():
        for field in (tr.field, tr.ema_field):
            for name, p in field.named_parameters():
                p.copy_(weights[name])
    return tr


def param_norms(named, fn) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(fn(k, p).float()))
            for k, p in named}


# ----------------------------------------------------------------------
# one run
# ----------------------------------------------------------------------

class Run:
    """One run of a cell: set-up, then the measured (``trace`` False) or
    traced (``trace`` True) window, and what the check compares."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, seconds: float,
                 trace: bool, device, t_start: float, limits=None):
        self.cfg_file = cfg_file
        self.limits = limits
        self.c = run_config(cfg_file)
        self.mix = mix
        self.seeds = Seeds.of(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.t_start = t_start
        self.out = {}           # what the check compares
        self.work = {}          # counts of the window
        self.trace_data = None
        self.failed = 0
        self.module = None      # entries/<entry>.py, for another entry

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- set-up ---------------------------------------------------------
    def _stage(self, name):
        self.sync()
        now = time.perf_counter()
        self.stages[name] = now - self._t_stage
        self._t_stage = now

    def setup(self):
        self.stages, self._t_stage = {}, time.perf_counter()
        self.stages["imports"] = self._t_stage - self.t_start
        # the scene is the configuration's data set, as a recorded
        # sequence is: its layout seed is fixed in the file; --seed draws
        # the weights, the rays, the noise and the frame order
        spec = self.cfg_file["scene"]
        self.scene = scenes.make_scene(spec, spec["layout_seed"], self.device)
        w = refmodel.init_params(self.c, self.seeds.weights, self.device)
        self._stage("scene and weights")
        self.tr = build_program(self.c, self.scene, w, self.seeds.trainer,
                                self.device)
        del w
        self._stage("program")
        F = self.c["num_frames"]
        self.rng = np.random.default_rng(self.seeds.order)
        self.perm = self.rng.permutation(F)
        entry = self.mix["entry"]
        if entry == "train":
            self.checked_start()
            self._stage("checked steps")
            self._stream = self._frame_stream(self.mix["frames_per_call"])
            for _ in range(self.mix["warmup_calls"]):
                self.train_call()
        elif entry == "render_lidar":
            # the settled state, made by the benchmark: the seed's weights
            # (already in the EMA field) and the grid of the scene's returns
            self.grid = scenes.returns_grid(self.c, self.scene,
                                            self.mix["grid_density"],
                                            self.device)
            with torch.no_grad():
                self.tr.occ_grid_lidar.copy_(self.grid)
            # every run renders the same frames, in its own seeded order
            self.pass_frames = np.arange(0, F, self.mix["frame_stride"])
            self._frames = self._pass_stream()
            for _ in range(self.mix["warmup_frames"]):
                self.tr.render_lidar_frame(int(next(self._frames)),
                                           use_ema=True)
        else:
            self.module = entry_module(entry)
            self.module.setup(self)
        self._stage("warm-up")
        self.setup_s = time.perf_counter() - self.t_start

    def _frame_stream(self, n):
        """Slices of ``n`` frames from an endless stream of seeded
        permutations of the scene's frames."""
        F = self.c["num_frames"]
        buf = []
        while True:
            while len(buf) < n:
                buf.extend(self.rng.permutation(F).tolist())
            yield np.asarray(buf[:n], np.int64)
            buf = buf[n:]

    def _pass_stream(self):
        """The pass's frames, each pass in a new seeded order."""
        while True:
            yield from self.rng.permutation(self.pass_frames).tolist()

    def checked_start(self):
        """The first steps, one frame a call through the training entry on
        distinct frames: the mix's ``checked`` modes in turn (random, then
        patch), each up to its first replay of the captured step (the
        eager warm-ups before it). Checked: the first step (from the
        benchmark's weights) and each replay (from the state before it,
        which is kept on the host for the reference): the loss terms, the
        frame's error maps, the gradient as Adam's first moment shows it
        ((m after - 0.9 m before) / 0.1), each parameter's change and its
        EMA's."""
        tr = self.tr
        steps = []
        for mode, n in self.mix["checked"]:
            steps += [mode == "patch"] * n
        if len(steps) > len(self.perm):
            raise ValueError(f"{len(steps)} checked steps on distinct frames "
                             f"need as many frames; the scene has "
                             f"{len(self.perm)}")
        steps = [(int(f), patch) for f, patch in zip(self.perm, steps)]
        replays = [k for k in range(len(steps))
                   if k + 1 == len(steps) or steps[k + 1][1] != steps[k][1]]
        named = dict(tr.field.named_parameters())
        ema = dict(tr.ema_field.named_parameters())
        opt = tr.optimizer.state

        def moment(key, n):
            # zeros where no step has left a state
            st = opt.get(named[n], {})
            return st[key] if key in st else torch.zeros_like(named[n])

        def snapshot(f):
            host = {key: {n: moment(key, n).detach().cpu().clone()
                          for n in named}
                    for key in ("exp_avg", "exp_avg_sq")}
            host["params"] = {n: p.detach().cpu().clone()
                              for n, p in named.items()}
            host["ema"] = {n: p.detach().cpu().clone() for n, p in ema.items()}
            host["maps"] = {"lidar": tr.error_map[f].cpu().clone(),
                            "rgb": tr.error_map_rgb[f].cpu().clone()}
            return host

        def norms(fn):
            return {n: float(torch.linalg.vector_norm(fn(n))) for n in named}

        out = {"steps": steps, "losses": {}, "parts": {}, "grads": {},
               "change": {}, "ema": {}, "error_rows": {}}
        states = {}
        for k, (f, patch) in enumerate(steps):
            tr.epoch = self.c["change_patch_size_epoch"] if patch else 0
            before = snapshot(f) if k == 0 or k in replays else None
            st = tr.train_one_epoch(order=[f])
            if before is None:
                continue
            dev = self.device
            out["losses"][k] = float(st.loss)
            out["parts"][k] = {n: v for n, v in st.parts.items()
                               if n != "loss"}
            out["error_rows"][k] = {
                "lidar": tr.error_map[f].cpu().clone().numpy(),
                "rgb": tr.error_map_rgb[f].cpu().clone().numpy()}
            out["grads"][k] = norms(lambda n: (
                moment("exp_avg", n) - 0.9 * before["exp_avg"][n].to(dev))
                / 0.1)
            out["change"][k] = norms(
                lambda n: named[n].detach() - before["params"][n].to(dev))
            out["ema"][k] = norms(
                lambda n: ema[n].detach() - before["ema"][n].to(dev))
            if k in replays:
                states[k] = before
            del before
        tr.epoch = 0
        self.out["train"] = out
        self.states = states

    # -- the entries ----------------------------------------------------
    def train_call(self):
        self.tr.epoch += 1
        order = next(self._stream)
        loss = self.tr.train_one_epoch(order=order).loss
        self.failed += 0 if np.isfinite(loss) else len(order)
        return len(order)

    def render_frame(self):
        fi = int(next(self._frames))
        pano = self.tr.render_lidar_frame(fi, use_ema=True)
        self.failed += 0 if all(np.isfinite(v).all() for v in pano.values()) \
            else 1
        return fi, pano

    # -- the window -----------------------------------------------------
    def window(self):
        """Whole calls (or passes over the render mix's frames) until
        ``seconds`` have passed (measured), or the mix's traced calls or
        frames under the profiler (traced)."""
        entry = self.mix["entry"]
        if self.trace:
            self._traced(entry)
        else:
            self._measured(entry)
        if self.device.type == "cuda":
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))
        else:
            self.memory_peak = 0

    def _one(self, entry, rendered):
        """One call of the training entry, or one pass over the render
        mix's frames; the steps or frames it ran."""
        if entry == "train":
            return self.train_call()
        if self.module:
            return self.module.unit(self)
        for _ in self.pass_frames:
            rendered.append(self.render_frame())
        return len(self.pass_frames)

    def _measured(self, entry):
        rendered = []
        count = 0
        self.sync()
        t0 = time.perf_counter()
        while True:
            count += self._one(entry, rendered)
            if time.perf_counter() - t0 >= self.seconds:
                break
        self.sync()
        wall = time.perf_counter() - t0
        self._finish_window(entry, count, wall, rendered)

    def _finish_window(self, entry, count, wall, rendered):
        c = self.c
        self.work = {"wall_s": wall, "count": count}
        if entry == "train":
            self.work["rays"] = count * (c["num_rays_lidar"] + c["num_rays"])
        elif entry == "render_lidar":
            Hl, Wl = self.scene["panos"].shape[1:3]
            self.work["rays"] = count * Hl * Wl
            self.out["frames"] = rendered

    def _traced(self, entry):
        from perfbench import trace as tracing
        tr = self.tr
        rendered = []
        refresh0 = tr.occ_refresh_count
        slabs = tr.ema_renderer.slab_counter(self.device)
        slabs0 = int(slabs)
        self.sync()
        with tracing.Window(self.device) as win:
            if entry == "train":
                count = sum(self.train_call()
                            for _ in range(self.mix["trace_calls"]))
            elif entry == "render_lidar":
                for _ in range(self.mix["trace_frames"]):
                    rendered.append(self.render_frame())
                count = len(rendered)
            else:
                count = sum(self.module.unit(self)
                            for _ in range(self.mix["trace_units"]))
            self.sync()
        self._finish_window(entry, count, win.wall_s, rendered)
        self.work.update(
            refreshes=tr.occ_refresh_count - refresh0,
            slabs_run=int(slabs) - slabs0,
            flow_points=int(tr.pc_data["pc"].shape[1])
            if tr.pc_data is not None else 0)
        self.trace_data = win

    # -- after the window -------------------------------------------------
    def release(self):
        """The program freed once the window has closed; what the check
        compares is in ``out`` (and the states before the checked replays,
        on the host, in ``states``)."""
        self.tr = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def device_info(self, n_chips: int) -> dict:
        if self.device.type == "cuda":
            kind = torch.cuda.get_device_name(self.device)
        else:
            kind = "cpu"
        d = {"platform": "gpu" if self.device.type == "cuda" else "cpu",
             "kind": kind, "count": n_chips,
             "memory_peak_bytes": self.memory_peak}
        if self.trace_data is not None:
            d["busy_s"] = self.trace_data.busy_s
            d["window_s"] = self.trace_data.wall_s
        return d


def end_to_end(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    """The cell's end-to-end metrics from the host clock; a metric's
    measure is named by its name up to the first dot
    (``train_rays_per_s.dense`` is the training rate of another cell)."""
    vals = {"setup_s": run.setup_s}
    if run.module:
        vals = {**run.module.measures(run), **vals}
    else:
        rate = run.work["rays"] / run.work["wall_s"]
        if run.mix["entry"] == "train":
            vals["train_rays_per_s"] = rate
        else:
            vals["render_rays_per_s"] = rate
    out = {}
    for m in metrics:
        base = m["name"].split(".", 1)[0]
        if base not in vals:
            raise KeyError(f"end-to-end metric {m['name']!r} has no "
                           f"measure in a {run.mix['entry']} mix")
        out[m["name"]] = {"value": vals[base], "unit": m["unit"]}
    return out


def per_layer(run: Run, metrics: List[dict], base: Path = HERE
              ) -> Dict[str, dict]:
    """The cell's per-layer metrics from the traced window; a reader that
    finds nothing to read leaves its metric out."""
    out = {}
    for m in metrics:
        v = metric_reader(m["name"], base)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def breakdown(run: Run) -> Optional[dict]:
    return run.trace_data.breakdown() if run.trace_data is not None else None
