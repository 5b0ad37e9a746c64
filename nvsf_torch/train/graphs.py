"""One program captured as a CUDA graph and replayed: the counterpart of a
``jax.jit`` of a program that the host calls again and again with new
values at the same shapes. The port captures so the JAX package's occupancy
refresh (``_occ_update``, ``nvsf_tpu/train/trainer.py:270-279``;
``Trainer.refresh_occupancy``), its U-Net refine step (``step_fn``,
``nvsf_tpu/train/refine.py:76-92``; ``train/refine.py::RefineSteps``) and
its mesh export's density query (``q``, ``nvsf_tpu/render/export.py:
36-46``; ``render/export.py::extract_density_grid``), and the training
step's random and patch modes (``train/step_graph.py``). The frame renders,
whose slab loops are conditional nodes, have graphs of their own
(``render/frame_graph.py``).

``Program(fn, device)`` calls ``fn(**inputs)``. Its first ``warmups``
calls run ``fn`` eagerly on the capture's side stream: they are real calls,
whose effects and outputs count. They build the kernel library and create
the state ``fn`` reads (gradients, Adam's moments, cuBLAS's workspace). The
last of them runs under ``torch.cuda.set_sync_debug_mode("error")``, so a
host synchronisation in ``fn`` raises there, with its cause, before any
capture. The next call captures ``fn`` with the given generators
registered (every replay then draws from each generator's state at that
time: a ``manual_seed`` between replays reaches the next one) and replays
it; a failed capture raises, and nothing falls back to the eager call.

Each call's ``inputs`` (device tensors) are copied into static inputs
allocated at the first call, outside the graph's pool; ``fn``'s outputs are
copied, inside the graph, into buffers outside the pool, which the next
call overwrites. A replay reads every other tensor at the address it had at
capture: ``held()`` names the tensors that must not have been replaced
since, and a replay refuses to run when one was. The owner drops the
program when its state is replaced (``Trainer.drop_step_graphs``).

The kernel wrappers count their launches in Python, which a replay does
not run: the launches a capture recorded (``kernels.LAUNCHES``), and what
it added to any other ``counters`` (``Mesh.collectives``, dicts of counts,
nested or not), are taken back out of the counts and added once per
replay. Programs that never run at once may share one memory pool and its
capture stream (``pool``, ``stream``; the allocator hands a capture only
its stream's free blocks).
"""

from __future__ import annotations

import contextlib
import copy
import gc
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch
from torch.utils import _pytree as pytree

from nvsf_torch.ops import kernels


def _delta(after, before):
    """``after - before``, key by key, of dicts of counts (nested or not)."""
    return {k: _delta(v, before.get(k, {})) if isinstance(v, dict)
            else v - before.get(k, 0) for k, v in after.items()}


def _add(counts, delta) -> None:
    for k, d in delta.items():
        if isinstance(d, dict):
            _add(counts.setdefault(k, {}), d)
        else:
            counts[k] = counts.get(k, 0) + d


@contextlib.contextmanager
def capture(graph: "torch.cuda.CUDAGraph", **kwargs):
    """``torch.cuda.graph(graph, **kwargs)`` with Python's cyclic garbage
    collector held off: a collection inside the capture may free an
    unreachable object that owns CUDA memory (a dropped program's graph
    and pool), and freeing it on the capturing thread invalidates the
    capture. Torch no longer collects before a capture, so such objects
    wait for the next collection outside one."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, **kwargs):
            yield
    finally:
        if enabled:
            gc.enable()


def _named(tensors):
    return (tensors.items() if isinstance(tensors, Mapping)
            else enumerate(tensors))


class Program:
    """``fn(**inputs)`` on the card, replayed from a CUDA graph after
    ``warmups`` eager calls (at least one). ``held()`` returns the tensors
    a replay reads or writes in place (a list, or a dict by name)."""

    def __init__(self, fn: Callable, device, *, warmups: int = 1,
                 generators: Iterable[torch.Generator] = (),
                 held: Optional[Callable[[], Iterable[torch.Tensor]]] = None,
                 counters: Iterable[dict] = (), pool=None,
                 stream: Optional[torch.cuda.Stream] = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs the card, got {device}; "
                             "the CPU runs the program eagerly")
        if warmups < 1:
            raise ValueError("the last eager warm-up checks for host syncs: "
                             f"warmups must be at least 1, got {warmups}")
        self.fn = fn
        self.device = device
        self.warmups = warmups
        self.generators = tuple(generators)
        self.held = held or (lambda: ())
        self.counters = tuple(counters)
        self.stream = stream or torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle() if pool is None else pool
        self.warm = 0
        self.replays = 0
        self.capture_s: Optional[float] = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: Optional[Dict[str, torch.Tensor]] = None
        self.outputs = None
        self.launches: Dict[str, int] = {}
        self._counts = ()
        self._held = {}

    @property
    def warming(self) -> bool:
        """Whether the next call runs eagerly."""
        return self.graph is None and self.warm < self.warmups

    def _hold(self) -> None:
        now = {k: (t, t.data_ptr()) for k, t in _named(self.held())}
        moved = [k for k, (t, ptr) in self._held.items()
                 if k not in now or now[k][0] is not t or now[k][1] != ptr]
        if moved or len(now) != len(self._held):
            raise RuntimeError(
                f"the captured program reads {moved or 'state'} at the "
                "addresses they had at its capture, and they were replaced "
                "since; drop the program (Trainer.drop_step_graphs()) after "
                "replacing state")

    def __call__(self, **inputs):
        if self.inputs is None:
            self.inputs = {k: torch.empty(v.shape, dtype=v.dtype,
                                          device=self.device)
                           for k, v in inputs.items()}
        for k, v in inputs.items():
            self.inputs[k].copy_(v, non_blocking=True)
        if self.warming:
            return self._warmup()
        if self.graph is None:
            self._capture()
        self._hold()
        self.graph.replay()
        self.replays += 1
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n
        for counts, d in zip(self.counters, self._counts):
            _add(counts, d)
        return self.outputs

    def _warmup(self):
        self.warm += 1
        last = self.warm == self.warmups
        mode = torch.cuda.get_sync_debug_mode()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        try:
            with torch.cuda.stream(self.stream):
                if last:
                    torch.cuda.set_sync_debug_mode("error")
                out = self.fn(**self.inputs)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        cur.wait_stream(self.stream)
        if last:
            # the replays' outputs, outside the graph's pool
            self.outputs = pytree.tree_map_only(torch.Tensor,
                                                torch.empty_like, out)
        return out

    def _capture(self) -> None:
        launches0 = dict(kernels.LAUNCHES)
        counts0 = [copy.deepcopy(c) for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        # thread_local: an NCCL watchdog thread's event queries do not
        # break the capture
        with capture(graph, pool=self.pool, stream=self.stream,
                     capture_error_mode="thread_local"):
            out = self.fn(**self.inputs)
            for o, x in zip(pytree.tree_leaves(self.outputs),
                            pytree.tree_leaves(out)):
                if torch.is_tensor(o):
                    o.copy_(x.detach())
            del out
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: kernels.LAUNCHES[k] - launches0[k]
                         for k in kernels.LAUNCHES}
        kernels.LAUNCHES.update(launches0)
        self._counts = [_delta(c, c0) for c, c0 in zip(self.counters,
                                                       counts0)]
        for c, c0 in zip(self.counters, counts0):
            c.clear()
            c.update(c0)
        self.graph = graph
        self._held = {k: (t, t.data_ptr()) for k, t in _named(self.held())}
