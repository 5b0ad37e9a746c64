"""The training step captured as CUDA graphs and replayed: the counterpart
of the JAX package's ``jax.jit`` of its step and of the body of its epoch
``lax.scan`` (``nvsf_tpu/train/trainer.py:246-258, 615-621``), which run an
epoch's dispatch as one device program because the host's dispatch of the
step's ~10,000 small kernels costs more than their device time.

``StepGraphs(trainer)`` holds one ``torch.cuda.CUDAGraph`` for the random
step and one for the patch step, sharing one memory pool (they never run
together). ``step(fi, patch)`` writes the frame index into the trainer's
static input (an int64 device scalar), replays the mode's graph and
returns its static outputs, the loss and its parts: the next replay
overwrites them, so a caller adds them up before it steps again. A replay
runs ``Trainer.step_body``: gradients zeroed in place, forward, backward,
NaN gradients zeroed, capturable Adam, the error-map rows (under an NCCL
mesh also the gradient all-reduce and the rows' broadcast). The host keeps
between replays what a step does there (``Trainer.end_step``): the
scheduler, which fills Adam's learning-rate tensors in place, and
``global_step``, which fills the device scalar the URF loss reads.

A mode's first ``WARMUP_STEPS`` steps run eagerly on the capture's side
stream. They are real steps of the epoch, counted in ``global_step`` and
its metrics; they build the kernel library, create every gradient and
Adam's state, and make the step's constants (``lib/constants.py``). The
last of them runs under ``torch.cuda.set_sync_debug_mode("error")``: a host
synchronisation in the step raises there, with its cause, before any
capture. The next step is captured and replayed; a failed capture raises.

A graph reads every tensor at the address it had at capture. The trainer
therefore writes the occupancy grids in place when it refreshes them and
drops its graphs on any load (``Trainer.drop_step_graphs``), and the epoch
re-captures; a replay refuses to run when an error map, a grid, a
learning rate or an Adam state tensor was replaced since its capture. The
gradients the graphs write are kept here and put back into ``.grad``
before each replay: an eager caller may drop them (``zero_grad()``), which
would hand their memory to other tensors. The trainer's generator is
registered with each graph, so that every replay draws new rays and noise
from it.

The kernel wrappers count their launches in Python, which a replay does
not run: the launches a capture recorded (``kernels.LAUNCHES``) and the
collectives it issued (``Mesh.collectives``) are counted once at capture,
taken back out, and added per replay.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass
from typing import Dict

import torch

from nvsf_torch.ops import kernels

WARMUP_STEPS = 2


@dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    outputs: Dict[str, torch.Tensor]
    launches: Dict[str, int]
    collectives: Dict[str, Dict[str, int]]


def _collectives_delta(after, before):
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
            for k, v in after.items()}


class StepGraphs:
    """The captured random and patch steps of one trainer on the card."""

    def __init__(self, trainer):
        if trainer.device.type != "cuda":
            raise ValueError("a CUDA graph needs the card; the CPU runs the "
                             "scanned epoch eagerly")
        mesh = trainer.mesh
        if mesh is not None:
            import torch.distributed as dist
            if dist.get_backend() != "nccl":
                raise RuntimeError(
                    f"use_scan=True captures the step as a CUDA graph, and "
                    f"the mesh's {dist.get_backend()} collectives on CUDA "
                    "tensors cannot be captured (only NCCL's can); pass "
                    "use_scan=False")
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(
                "this torch cannot register the trainer's generator with a "
                "CUDA graph (CUDAGraph.register_generator_state): every "
                "replay would draw the same rays; pass use_scan=False")
        self.trainer = trainer
        self.stream = torch.cuda.Stream(trainer.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[bool, _Captured] = {}
        self.warm = {False: 0, True: 0}
        self.replays = {False: 0, True: 0}
        self.capture_s: Dict[bool, float] = {}
        self._grads = None      # the .grad tensors the graphs write
        self._state = None      # the state tensors they read, by name

    def _state_tensors(self) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        named = {k: getattr(tr, k) for k in (
            "error_map", "error_map_rgb", "occ_grid_lidar", "occ_grid_rgb")
            if getattr(tr, k) is not None}
        for i, group in enumerate(tr.optimizer.param_groups):
            named[f"lr {i}"] = group["lr"]
        for i, p in enumerate(tr.field.parameters()):
            for k, v in tr.optimizer.state.get(p, {}).items():
                named[f"adam {k} {i}"] = v
        return named

    def _hold(self) -> None:
        """Put the captured gradients back and refuse replaced state."""
        params = list(self.trainer.field.parameters())
        if self._grads is None:
            self._grads = [torch.zeros_like(p) if p.grad is None else p.grad
                           for p in params]
            self._state = self._state_tensors()
        for p, g in zip(params, self._grads):
            if p.grad is not g:
                p.grad = g
        now = self._state_tensors()
        moved = [k for k, t in self._state.items() if now.get(k) is not t]
        if moved or len(now) != len(self._state):
            raise RuntimeError(
                f"the captured steps read {moved or 'state'} at addresses "
                "that were replaced since the capture; call "
                "Trainer.drop_step_graphs() after replacing trainer state")

    def step(self, fi: int, patch: bool) -> Dict[str, torch.Tensor]:
        """One step of frame ``fi``: a replay once the mode is captured;
        its metrics are the graph's static outputs."""
        tr = self.trainer
        tr._fi.fill_(int(fi))
        patch = bool(patch)
        if patch not in self.graphs and self.warm[patch] >= WARMUP_STEPS:
            self.graphs[patch] = self._capture(patch)
        if patch in self.graphs:
            cap = self.graphs[patch]
            self._hold()
            cap.graph.replay()
            self.replays[patch] += 1
            for k, n in cap.launches.items():
                kernels.LAUNCHES[k] += n
            if tr.mesh is not None:
                for k, c in cap.collectives.items():
                    mine = tr.mesh.collectives.setdefault(
                        k, {"calls": 0, "bytes": 0})
                    for f, v in c.items():
                        mine[f] += v
            out = cap.outputs
        else:
            out = self._warmup(patch)
        tr.end_step()
        return out

    def _warmup(self, patch: bool) -> Dict[str, torch.Tensor]:
        tr = self.trainer
        self.warm[patch] += 1
        checked = self.warm[patch] == WARMUP_STEPS
        mode = torch.cuda.get_sync_debug_mode()
        self.stream.wait_stream(torch.cuda.current_stream())
        try:
            with torch.cuda.stream(self.stream):
                if checked:
                    torch.cuda.set_sync_debug_mode("error")
                out = tr.step_body(tr._fi, patch)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(self.stream)
        return out

    def _capture(self, patch: bool) -> _Captured:
        tr = self.trainer
        mesh = tr.mesh
        launches0 = dict(kernels.LAUNCHES)
        coll0 = copy.deepcopy(mesh.collectives) if mesh is not None else {}
        self._hold()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(tr.generator)
        torch.cuda.synchronize(tr.device)
        t0 = time.perf_counter()
        # thread_local: an NCCL watchdog thread's event queries do not
        # break the capture
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"):
            outputs = tr.step_body(tr._fi, patch)
        torch.cuda.synchronize(tr.device)
        self.capture_s[patch] = time.perf_counter() - t0
        launches = {k: kernels.LAUNCHES[k] - launches0[k]
                    for k in kernels.LAUNCHES}
        kernels.LAUNCHES.update(launches0)
        collectives = {}
        if mesh is not None:
            collectives = _collectives_delta(mesh.collectives, coll0)
            mesh.collectives.clear()
            mesh.collectives.update(coll0)
        return _Captured(graph, outputs, launches, collectives)
