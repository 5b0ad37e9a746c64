"""The training step captured as CUDA graphs and replayed: the counterpart
of the JAX package's ``jax.jit`` of its step and of the body of its epoch
``lax.scan`` (``nvsf_tpu/train/trainer.py:246-258, 615-621``), which run an
epoch's dispatch as one device program because the host's dispatch of the
step's ~10,000 small kernels costs more than their device time.

``StepGraphs(trainer)`` holds one ``torch.cuda.CUDAGraph`` for the random
step and one for the patch step, sharing one memory pool (they never run
together). ``step(fi, patch)`` writes the frame index into the trainer's
static input (an int64 device scalar), replays the mode's graph and
returns its outputs, the loss and its parts, copied out of the pool: the
next replay overwrites them, so a caller adds them up before it steps
again. A replay
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

Each mode is a ``train/graphs.py::Program``, which does the warm-ups, the
capture and the replays, and counts a replay's kernel launches and mesh
collectives (``kernels.LAUNCHES``, ``Mesh.collectives``) as its capture
recorded them.
"""

from __future__ import annotations

from typing import Dict

import torch

from nvsf_torch.train.graphs import Program

WARMUP_STEPS = 2


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
        self.modes = {patch: Program(
            lambda patch=patch: trainer.step_body(trainer._fi, patch),
            trainer.device, warmups=WARMUP_STEPS,
            generators=[trainer.generator], held=self._state_tensors,
            counters=[mesh.collectives] if mesh is not None else [],
            pool=self.pool, stream=self.stream) for patch in (False, True)}
        self._grads = None      # the .grad tensors the graphs write

    @property
    def graphs(self) -> Dict[bool, "torch.cuda.CUDAGraph"]:
        """The captured modes' graphs."""
        return {m: p.graph for m, p in self.modes.items()
                if p.graph is not None}

    @property
    def replays(self) -> Dict[bool, int]:
        return {m: p.replays for m, p in self.modes.items()}

    @property
    def capture_s(self) -> Dict[bool, float]:
        return {m: p.capture_s for m, p in self.modes.items()
                if p.capture_s is not None}

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

    def _hold_grads(self) -> None:
        """Put the gradients the graphs write back into ``.grad``."""
        params = list(self.trainer.field.parameters())
        if self._grads is None:
            self._grads = [torch.zeros_like(p) if p.grad is None else p.grad
                           for p in params]
        for p, g in zip(params, self._grads):
            if p.grad is not g:
                p.grad = g

    def step(self, fi: int, patch: bool) -> Dict[str, torch.Tensor]:
        """One step of frame ``fi``: a replay once the mode is captured,
        whose metrics the next replay overwrites. Each part of the host's
        work is a span of the trainer's timers (``step.fill``,
        ``step.hold_grads``, ``step.replay``, ``step.end_step``), so that
        a device trace names the part the host was in."""
        tr = self.trainer
        span = tr.timers.span
        with span("step.fill"):
            tr._fi.fill_(int(fi))
        prog = self.modes[bool(patch)]
        if not prog.warming:
            with span("step.hold_grads"):
                self._hold_grads()
        with span("step.replay"):
            out = prog()
        with span("step.end_step"):
            tr.end_step()
        return out
