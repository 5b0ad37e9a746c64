"""The frame renders captured as CUDA graphs and replayed: the counterpart of
the JAX package's jitted frame renders (``self._eval_lidar`` and
``_eval_camera``, ``nvsf_tpu/train/trainer.py:286-287``; the novel-sensor
renderers of ``_render_cache``, ``:811-844``; the sweeps, jitted per shape,
``nvsf_tpu/render/sweep.py``), which render a frame as one device program:
the compaction and the render chunks run in ``lax.map``
(``nvsf_tpu/render/renderer.py:683, 718, 809``), each chunk's early-exit
marcher in a ``lax.while_loop`` over slabs (``:555-635``), and no value goes
back to the host until the frame is done.

``FrameGraphs(renderer)`` (``Renderer.frame_graphs``, one per renderer) holds
one graph per stage of a frame, keyed as the JAX package keys its compiled
renders, by what the stage's program depends on:
  - the stage before the chunks, one graph per frame shape: the rays from a
    pose (``lib/rays.py``) or the given rays, and for the occupancy marcher
    near/far, the compaction in chunks of ``COMPACT_CHUNK``, the stable sort
    and the padding (``Renderer.occ_frame_pre``; its key holds the grid's
    address, shape and the grid spec); for the dense render the padding to
    whole chunks (``Renderer.dense_frame_pre``);
  - the chunk, the ``lax.map`` body: the marcher over ``max_ray_batch``
    sorted rays (``Renderer.occ_chunk``), or a dense chunk through
    ``Renderer.run``; its static inputs are the chunk's rays, samples and
    the frame's time, filled with device-to-device copies before each
    replay; its outputs are copied into the frame's buffers after it;
  - the stage after the chunks (the marcher's un-sort and background).
Inside a chunk's graph the marcher's slab loop is a chain of conditional IF
nodes (``if_node``, ``csrc/graph_cond.cu``): before slab i the device
computes "is a ray of the chunk alive" and runs the slab only where it is;
once false it stays false, so the skipped nodes are the while_loop's exit.
Between the upload of a frame's pose (or rays) and its outputs, the host
only queues copies and replays: no value comes back to it.

Each graph is captured at its first use, after one eager warm-up of the
stage at its shapes on the capture's side stream, under
``torch.cuda.set_sync_debug_mode("error")``: a host synchronisation left in
a stage raises there, with its cause. The warm-up builds the kernel library,
sets B3's shared-memory attribute at the sizes the capture asks for and
makes the constants (``lib/constants.py``); in it the marcher runs every
slab with its carry's writes gated on the device's predicate
(``Renderer._slab_steps``), and what it adds to ``slabs_run`` is taken back.
A failed capture raises; nothing falls back to the eager render.

The graphs of every renderer on a card share one memory pool (``_Pools``),
apart from the steps' (``train/step_graph.py``); the bodies of their IF
nodes allocate from a second one, as the allocator routes a capture's
stream to one pool only. They are captured on shared streams too: the
allocator gives a capture only free blocks of its own stream. Each graph copies its outputs into buffers outside
the pools before it ends, so the pools hold only the graphs' scratch, which
no replay reads after it ends: graphs that never run at once (render
graphs never do) may then share the pools whatever the order of their
replays. A frame's outputs are cloned out of those buffers before the next
replay, so a caller may keep them. A graph reads the field's parameters
and the grid at the addresses they had at its capture: the trainer updates
both in place, a load drops the graphs (``Trainer.drop_step_graphs``), and
a replay refuses a field whose parameters were replaced; the pools are
freed with the last renderer's graphs.

The kernel wrappers count their launches in Python, which a replay does
not run: a capture's launches outside IF nodes (``kernels.LAUNCHES``,
``graph_if`` for the IF nodes' own kernels) are counted once per replay;
each IF node's body adds its launches to a counter on the device
(``kernels.device_launch_counter``) where it runs, so a slab that the
device skips counts none (``kernels.launch_counts`` reads them).
``Renderer.slabs_run`` counts on the device the slabs that ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from nvsf_torch.ops import kernels
from nvsf_torch.train.graphs import capture

# cudaStreamCaptureModeThreadLocal, as the captures' own mode
_THREAD_LOCAL = 1


def run_chunks(C: int, chunk, ins, outs) -> None:
    """``chunk(*rows)`` for each run of ``C`` rows of the arrays ``ins``,
    its outputs written into the same rows of the buffers ``outs`` (the
    ``lax.map`` over a frame's chunks, eager or replayed)."""
    for c in range(0, ins[0].shape[0], C):
        for o, r in zip(outs, chunk(*(a[c:c + C] for a in ins))):
            o[c:c + C].copy_(r)


@contextlib.contextmanager
def if_node(pred: torch.Tensor, body_stream: "torch.cuda.Stream",
            body_pool: "torch.cuda.MemPool"):
    """Inside a capture on the current stream: the work issued in the
    block becomes the body of a conditional IF node, which a replay runs
    only when the device bool ``pred`` [] is true at that point of the
    graph (``csrc/graph_cond.cu``). The body is captured on
    ``body_stream`` and allocates from ``body_pool``: the allocator routes
    only the outer capture's stream to the graph's own pool. Each call
    counts one ``graph_if`` launch (the kernel that sets the node's
    condition)."""
    if pred.dtype != torch.bool or pred.numel() != 1 or not pred.is_cuda:
        raise ValueError(f"an IF node's predicate is one bool on the card, "
                         f"got {pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")
    lib = kernels.library()
    dev = pred.device
    outer = torch.cuda.current_stream(dev)
    kernels.check(lib, lib.nvsf_graph_begin_if(
        outer.cuda_stream, body_stream.cuda_stream, pred.data_ptr(),
        _THREAD_LOCAL), "nvsf_graph_begin_if")
    kernels.LAUNCHES["graph_if"] += 1
    try:
        with torch.cuda.stream(body_stream):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index,
                                                            body_pool.id)
            try:
                yield
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, body_pool.id)
                torch._C._cuda_releasePool(dev.index, body_pool.id)
    finally:
        kernels.check(lib, lib.nvsf_graph_end_if(body_stream.cuda_stream),
                      "nvsf_graph_end_if")


class _Pools:
    """The memory pools of the frame graphs on one card, the graphs' own
    (a ``graph_pool_handle``) and their IF bodies' (a ``MemPool``), and
    the streams their captures run on: the allocator hands a capture only
    the free blocks of its own stream, so graphs that share a pool share
    its streams too."""

    def __init__(self, device: torch.device):
        with torch.cuda.device(device):
            self.graph = torch.cuda.graph_pool_handle()
            self.body = torch.cuda.MemPool()
        self.capture_stream = torch.cuda.Stream(device)
        self.body_stream = torch.cuda.Stream(device)

    def bytes(self) -> int:
        """The memory the two pools hold: the segments they own."""
        ids = {tuple(self.graph), tuple(self.body.id)}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in ids)


# the pools and streams of each card, alive while a renderer's graphs
# hold them
_POOLS: "weakref.WeakValueDictionary[torch.device, _Pools]" = \
    weakref.WeakValueDictionary()


def shared_pools(device: torch.device) -> _Pools:
    """The pools and streams that every renderer's frame graphs on
    ``device`` share."""
    pools = _POOLS.get(device)
    if pools is None:
        pools = _POOLS[device] = _Pools(device)
    return pools


@dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]     # static, filled before each replay
    outputs: Any                        # static: the next replay overwrites
    launches: Dict[str, int]            # outside IF nodes, each replay
    held: Tuple[torch.Tensor, ...]      # read at their capture address


class FrameGraphs:
    """The captured frame renders of one ``Renderer`` on the card."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.graphs: Dict[tuple, _Captured] = {}
        self.capture_s: Dict[tuple, float] = {}
        # GiB that the shared pools grew by at each capture: the scratch
        # it needed beyond what earlier captures had left free
        self.capture_gib: Dict[tuple, float] = {}
        self.replays = 0
        self.capturing = False
        self.device = None
        self._buffers: Dict[tuple, tuple] = {}
        self._in_bodies: Dict[str, int] = {}

    def _setup(self, device: torch.device) -> None:
        if self.device is not None:
            if device != self.device:
                raise ValueError(f"frame graphs of {self.device} asked to "
                                 f"render on {device}")
            return
        if device.type != "cuda":
            raise ValueError("a CUDA graph needs the card; the CPU renders "
                             "eagerly (Renderer.render_eager)")
        self.device = device
        self.pools = shared_pools(device)
        self.body_launches = kernels.device_launch_counter(device)
        self.time = torch.zeros((), device=device)
        self._slabs = self.renderer.slab_counter(device)
        self._params = [(p, p.data_ptr())
                        for p in self.renderer.field.parameters()]

    def _hold(self) -> None:
        """Refuse a field or a slab counter replaced since the captures."""
        now = list(self.renderer.field.parameters())
        if (len(now) != len(self._params)
                or any(p is not q or p.data_ptr() != ptr
                       for p, (q, ptr) in zip(now, self._params))
                or self.renderer.slabs_run is not self._slabs):
            raise RuntimeError(
                "the frame graphs read the field's parameters and slabs_run "
                "at the addresses they had at capture, and these were "
                "replaced since; call Renderer.drop_frame_graphs() (a "
                "trainer's drop_step_graphs() drops its renderers')")

    # ------------------------------------------------------------------
    # capture and replay
    # ------------------------------------------------------------------
    def if_node(self, pred: torch.Tensor):
        """``if_node`` on the shared body stream and pool."""
        return if_node(pred, self.pools.body_stream, self.pools.body)

    def _slab_steps(self, n: int, alive, body) -> None:
        """The marcher's slab loop as a capture records it
        (``Renderer._stream_composite``'s ``slab_steps``): each ``body(i,
        None)`` the body of an IF node on ``alive(i)``, which adds the
        launches it makes to ``body_launches`` where the device runs it."""
        for i in range(n):
            with self.if_node(alive(i)):
                before = dict(kernels.LAUNCHES)
                body(i, None)
                for j, (k, now) in enumerate(kernels.LAUNCHES.items()):
                    if now > before[k]:
                        self.body_launches[j].add_(now - before[k])
                        self._in_bodies[k] += now - before[k]

    def slab_steps(self):
        """The slab loop for a chunk's marcher: the IF nodes at a capture,
        the renderer's own (None) at the warm-up."""
        return self._slab_steps if self.capturing else None

    def _capture(self, key, fn, static, held) -> _Captured:
        counter = self._slabs
        cur = torch.cuda.current_stream(self.device)
        self.pools.capture_stream.wait_stream(cur)
        mode = torch.cuda.get_sync_debug_mode()
        try:
            with torch.cuda.stream(self.pools.capture_stream):
                saved = counter.clone()
                torch.cuda.set_sync_debug_mode("error")
                warm = fn(**static)
                counter.copy_(saved)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        flat, spec = pytree.tree_flatten(warm)
        del warm
        outputs = [torch.empty_like(x) for x in flat]    # outside the pools
        del flat
        launches0 = dict(kernels.LAUNCHES)
        self._in_bodies = dict.fromkeys(kernels.LAUNCHES, 0)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        pool0 = self.pools.bytes()
        t0 = time.perf_counter()
        self.capturing = True
        try:
            with capture(graph, pool=self.pools.graph,
                         stream=self.pools.capture_stream,
                         capture_error_mode="thread_local"):
                for o, x in zip(outputs, pytree.tree_leaves(fn(**static))):
                    o.copy_(x)
        finally:
            self.capturing = False
        torch.cuda.synchronize(self.device)
        self.capture_s[key] = time.perf_counter() - t0
        self.capture_gib[key] = (self.pools.bytes() - pool0) / 2**30
        launches = {k: kernels.LAUNCHES[k] - launches0[k]
                    - self._in_bodies[k] for k in kernels.LAUNCHES}
        kernels.LAUNCHES.update(launches0)
        cur.wait_stream(self.pools.capture_stream)
        return _Captured(graph, static, pytree.tree_unflatten(outputs, spec),
                         launches, tuple(held))

    def _replay(self, key: tuple, fn, inputs: Dict[str, torch.Tensor],
                held=()):
        """``fn(**inputs)`` as a replay of the graph under ``key`` and the
        inputs' shapes, captured at its first call; ``inputs`` are copied
        into its static inputs before each replay. Returns the graph's
        static outputs."""
        key = key + tuple((k, tuple(v.shape), v.dtype)
                          for k, v in inputs.items())
        cap = self.graphs.get(key)
        static = cap.inputs if cap is not None else {
            k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
            for k, v in inputs.items()}
        for k, v in inputs.items():
            static[k].copy_(v, non_blocking=True)
        if cap is None:
            cap = self.graphs[key] = self._capture(key, fn, static, held)
        cap.graph.replay()
        self.replays += 1
        for k, n in cap.launches.items():
            kernels.LAUNCHES[k] += n
        return cap.outputs

    def _set_time(self, t) -> None:
        if torch.is_tensor(t):
            self.time.copy_(t.reshape(()), non_blocking=True)
        else:
            self.time.fill_(float(t))

    # ------------------------------------------------------------------
    # entry points
    # ------------------------------------------------------------------
    def render_frame(self, rays, rays_key: tuple, n_rays: int, inputs, t, *,
                     cal_lidar_color=False, bg_color=None, occ=None,
                     occ_grid=None, num_steps_occ=None, occ_thresh=0.01,
                     skip_warp=False) -> Dict[str, torch.Tensor]:
        """One frame of ``n_rays`` rays that ``rays(**inputs)`` makes on the
        card, rendered at time ``t`` (a float or a device scalar) as
        ``Renderer.render`` renders them: ``inputs`` are device tensors or
        host arrays (uploaded from pinned memory), ``rays_key`` names what
        else ``rays`` depends on. Returns fresh tensors."""
        r = self.renderer
        self._setup(next(r.field.parameters()).device)
        self._hold()
        inputs = {k: v if torch.is_tensor(v) else torch.as_tensor(
            np.asarray(v), dtype=torch.float32).pin_memory()
            for k, v in inputs.items()}
        self._set_time(t)
        lidar = bool(cal_lidar_color)
        if occ is None or occ_grid is None:
            return self._dense(rays, rays_key, n_rays, inputs, lidar,
                               bg_color, skip_warp)
        K = int(num_steps_occ)
        S = min(r.stream_slab, K)
        pre_key = ("occ-pre", rays_key, n_rays, lidar, K, occ_thresh,
                   dataclasses.astuple(occ), occ_grid.data_ptr(),
                   tuple(occ_grid.shape))

        def pre(**kw):
            return r.occ_frame_pre(*rays(**kw), occ, occ_grid, K, occ_thresh,
                                   lidar)

        ins, inv = self._replay(pre_key, pre, inputs, held=(occ_grid,))
        outs = self._frame_buffers(pre_key, ins[0].shape[0], lidar, True)

        def chunk(rays_o, rays_d, z_vals, valid, sample_dist, time):
            return r.occ_chunk(rays_o, rays_d, time, z_vals, valid,
                               sample_dist, lidar, S, skip_warp,
                               slab_steps=self.slab_steps())

        def replay_chunk(ro, rd, z, v, sd):
            return self._replay(
                ("occ-chunk", lidar, S, skip_warp), chunk,
                dict(rays_o=ro, rays_d=rd, z_vals=z, valid=v, sample_dist=sd,
                     time=self.time))

        run_chunks(r.chunk_rays(inv.shape[0]), replay_chunk, ins, outs)
        out = self._replay(
            ("occ-post", pre_key, bg_color),
            lambda: r.occ_frame_post(*outs, inv, n_rays, lidar, bg_color), {})
        return {k: v.clone() for k, v in out.items()}

    def _dense(self, rays, rays_key, n_rays, inputs, lidar, bg_color,
               skip_warp):
        r = self.renderer
        pre_key = ("dense-pre", rays_key, n_rays, r.chunk_rays(n_rays))
        ins = self._replay(pre_key, lambda **kw: r.dense_frame_pre(
            *rays(**kw)), inputs)
        outs = self._frame_buffers(pre_key, ins[0].shape[0], lidar)

        def chunk(rays_o, rays_d, time):
            return r.dense_chunk(rays_o, rays_d, time, lidar, bg_color,
                                 skip_warp)

        run_chunks(r.chunk_rays(n_rays), lambda ro, rd: self._replay(
            ("dense-chunk", lidar, bg_color, skip_warp), chunk,
            dict(rays_o=ro, rays_d=rd, time=self.time)), ins, outs)
        keys = (("depth_lidar", "image_lidar") if lidar
                else ("depth", "image"))
        return {k: o[:n_rays].clone() for k, o in zip(keys, outs)}

    def _frame_buffers(self, pre_key, n, lidar, wsum=False) -> tuple:
        key = (pre_key, lidar)
        if key not in self._buffers:
            self._buffers[key] = self.renderer.frame_outputs(n, lidar, wsum)
        return self._buffers[key]

    def render(self, rays_o, rays_d, time, **kw) -> Dict[str, torch.Tensor]:
        """``Renderer.render`` of device rays [N, 3] at the device time
        ``time``."""
        return self.render_frame(lambda rays_o, rays_d: (rays_o, rays_d),
                                 ("rays",), rays_o.shape[0],
                                 dict(rays_o=rays_o, rays_d=rays_d), time,
                                 **kw)

    def stream(self, rays_o, rays_d, time, occ, occ_grid,
               **kw) -> Dict[str, torch.Tensor]:
        """``Renderer.run_occupancy_stream`` of one batch as a replay."""
        r = self.renderer
        self._setup(rays_o.device)
        self._hold()
        self._set_time(time)
        key = ("stream", dataclasses.astuple(occ), occ_grid.data_ptr(),
               tuple(occ_grid.shape), tuple(sorted(kw.items())))

        def fn(rays_o, rays_d, time):
            return r.stream_batch(rays_o, rays_d, time, occ, occ_grid,
                                  slab_steps=self.slab_steps(), **kw)

        out = self._replay(
            key, fn, dict(rays_o=rays_o, rays_d=rays_d, time=self.time),
            held=(occ_grid,))
        return {k: v.clone() for k, v in out.items()}
