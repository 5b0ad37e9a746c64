"""Stage timers, spans and the device trace (counterpart of
``nvsf_tpu/train/profiler.py``).

``PhaseTimers`` accumulates wall time by stage (``phase``, which waits for
the device at each stage's end) and by host span (``span``, which does
not wait). Both record a host range ``nvsf/<name>`` while a profiler
records, so that the host's stages and its work around each step lie on
the device trace's clock and name the device's idle gaps. The ranges are
host ops, as an aten op is, not user annotations: the profiler would echo
an annotation on the device's timeline as one span over the kernels it
launched, which a reader of device time takes for a device op.

``span(name, device)`` marks a span of the training path or of the U-Net
refine step (``SPANS``) on the device: its open and its close each launch
a one-thread marker kernel named after it (``nvsf_span_open_encode_hash``;
``csrc/spans.cu``) on the current stream, so a CUDA graph captured around
the span replays its markers, and a device trace alone tells the spans
apart. On the CPU the markers are zero-length host ranges
``nvsf_span:open:<name>`` / ``nvsf_span:close:<name>``, made only while a
profiler records. With ``backward=True`` the span's backward is marked
too: ``s.out(outputs)`` passes the span's outputs through an identity
whose backward opens the span, and a token made at the span's open closes
it. A device's autograd nodes run newest first, so the token's node runs
right after every node that the span's forward made: the module's
backward, and the recomputation that ``torch.utils.checkpoint`` runs
inside it, are charged to the module.

``span_times(events)`` reduces a trace to self and inclusive times by
span; ``device_trace`` writes the Chrome trace and that reduction.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils import _pytree as pytree

from nvsf_torch.ops import kernels

# the spans of the training path and of the U-Net refine step, in the
# order of csrc/spans.cu's NVSF_SPANS (a marker kernel's name spells a dot
# as an underscore)
SPANS = ("sample", "render", "encode.hash", "encode.planes", "encode.flow",
         "mlp", "loss", "backward", "optim", "refresh", "unet.down",
         "unet.attn", "unet.up")
_INDEX = {n: i for i, n in enumerate(SPANS)}
NONE = "(none)"
_MARKER = re.compile(r"nvsf_span[_:](open|close)[_:]([a-z_.]+)")
_clock = time.perf_counter


def _host_range(name: str):
    """A host range ``name`` (a host op, not a user annotation)."""
    return torch._C._profiler._RecordFunctionFast(name)


def _range(name: str):
    """An entered host range ``nvsf/<name>`` while a profiler records,
    else None (the check costs a global's read)."""
    if not _autograd_profiler._is_profiler_enabled:
        return None
    rf = _host_range("nvsf/" + name)
    rf.__enter__()
    return rf


class _HostSpan:
    __slots__ = ("timers", "name", "t0", "rf")

    def __init__(self, timers: "PhaseTimers", name: str):
        self.timers, self.name = timers, name

    def __enter__(self):
        self.rf = _range(self.name) \
            if _autograd_profiler._is_profiler_enabled else None
        self.t0 = _clock()

    def __exit__(self, *exc):
        dt = _clock() - self.t0
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        tm, name = self.timers, self.name
        tm.totals[name] += dt
        tm.counts[name] += 1
        return False


class PhaseTimers:
    """Accumulating wall-clock timers by stage and host span name.

        with timers.phase("render"): ...
        with timers.span("step.dispatch"): ...
        print(timers.report())

    ``sync`` (``torch.cuda.synchronize`` for a trainer on the card) runs
    before each stage's clock stops, so that work queued on the device is
    charged to the stage that queued it; a span never waits, and times
    only the host. ``last`` holds each stage's most recent time."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        rf = _range(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.last[name] = time.perf_counter() - t0
            self.totals[name] += self.last[name]
            self.counts[name] += 1
            if rf is not None:
                rf.__exit__(None, None, None)

    def span(self, name: str) -> _HostSpan:
        return _HostSpan(self, name)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"  {name:24s} {t:8.3f}s  ({n}x, "
                         f"{t / max(n, 1) * 1e3:7.2f} ms/it)")
        return "\n".join(lines)


# ----------------------------------------------------------------------
# spans of the training path and the refine step
# ----------------------------------------------------------------------

def mark(name: str, is_open: bool, device: torch.device) -> None:
    """One end of span ``name``: a marker kernel on the card's current
    stream, a zero-length host event on the CPU while a profiler
    records."""
    if device.type == "cuda":
        lib = kernels.library()
        rc = lib.nvsf_span_mark(torch.cuda.current_stream(device).cuda_stream,
                                _INDEX[name], int(is_open))
        kernels.check(lib, rc, f"span marker {name}")
    elif _autograd_profiler._is_profiler_enabled:
        with _host_range(f"nvsf_span:{'open' if is_open else 'close'}:"
                         f"{name}"):
            pass


_ANCHORS: Dict[torch.device, torch.Tensor] = {}


def _anchor(device: torch.device) -> torch.Tensor:
    """An empty leaf that requires grad, so that a token has a node."""
    if device not in _ANCHORS:
        _ANCHORS[device] = torch.empty(0, device=device, requires_grad=True)
    return _ANCHORS[device]


class _Closes(torch.autograd.Function):
    """A span's token, made at its open: its backward closes the span."""

    @staticmethod
    def forward(ctx, name, anchor):
        ctx.name = name
        return anchor.new_empty(0)

    @staticmethod
    def backward(ctx, token):
        mark(ctx.name, False, token.device)
        return None, None


class _Opens(torch.autograd.Function):
    """The identity on a span's outputs: its backward opens the span and
    hands the token its (empty) gradient."""

    @staticmethod
    def forward(ctx, name, token, *ts):
        ctx.set_materialize_grads(False)
        ctx.name, ctx.token = name, token.detach()
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.name, True, ctx.token.device)
        return (None, ctx.token, *grads)


class span:
    """``with span(name, device) as s:`` marks the block as span ``name``
    of ``SPANS``. With ``backward=True`` (and gradients on), ``y =
    s.out(y)`` inside the block, on the span's outputs (any nesting of
    tensors), marks its backward too."""

    __slots__ = ("name", "device", "backward", "_token")

    def __init__(self, name: str, device: torch.device,
                 backward: bool = False):
        self.name, self.device, self.backward = name, device, backward

    def __enter__(self):
        mark(self.name, True, self.device)
        self._token = _Closes.apply(self.name, _anchor(self.device)) \
            if self.backward and torch.is_grad_enabled() else None
        return self

    def __exit__(self, *exc):
        mark(self.name, False, self.device)
        return False

    def out(self, tree):
        if self._token is None:
            return tree
        leaves, spec = pytree.tree_flatten(tree)
        idx = [i for i, t in enumerate(leaves)
               if torch.is_tensor(t) and t.requires_grad]
        if not idx:
            return tree
        wrapped = _Opens.apply(self.name, self._token,
                               *(leaves[i] for i in idx))
        for i, t in zip(idx, wrapped):
            leaves[i] = t
        self._token = None
        return pytree.tree_unflatten(leaves, spec)


def traced(name: str):
    """A decorator: each call of the function is span ``name``, forward
    and backward, on the device of its first tensor argument."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            dev = next(a.device for a in args if torch.is_tensor(a))
            with span(name, dev, backward=True) as s:
                return s.out(fn(*args, **kwargs))
        return call
    return wrap


# ----------------------------------------------------------------------
# the reduction and the trace
# ----------------------------------------------------------------------

def trace_events(prof):
    """(name, start_us, dur_us, on_device) of every event a
    ``torch.profiler.profile`` recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
             e.device_type() == cuda)
            for e in prof.profiler.kineto_results.events()]


def span_times(events) -> Dict[str, dict]:
    """Microseconds by span name from a trace's ``events`` [(name,
    start_us, dur_us, on_device)]: ``self_us`` (while the span was the
    innermost open one), ``inclusive_us``, ``opens`` and ``closes``;
    ``(none)`` holds the time outside every span. Where the device ran
    marker kernels, each device op's duration is charged, in start order,
    to the spans open at it (a marker to its own span); else the host's
    time between consecutive markers is, from the first event's start to
    the last one's end."""
    out = defaultdict(lambda: {"self_us": 0.0, "inclusive_us": 0.0,
                               "opens": 0, "closes": 0})
    stack = []

    def charge(us):
        out[stack[-1] if stack else NONE]["self_us"] += us
        for n in set(stack):
            out[n]["inclusive_us"] += us

    def turn(kind, name):
        if kind == "open":
            stack.append(name)
            out[name]["opens"] += 1
            return
        out[name]["closes"] += 1
        if name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name):]

    def marker(n):
        m = _MARKER.search(n)
        return (m.group(1), m.group(2).replace("_", ".")) if m else None

    device = sorted((e for e in events if e[3]), key=lambda e: e[1])
    if any(marker(n) for n, *_ in device):
        for n, _, d, _ in device:
            m = marker(n)
            if m and m[0] == "open":
                turn(*m)
            charge(d)
            if m and m[0] == "close":
                turn(*m)
    elif events:
        t = min(e[1] for e in events)
        end = max(e[1] + e[2] for e in events)
        for s, kind, name in sorted(
                (e[1], *marker(e[0])) for e in events
                if not e[3] and marker(e[0])):
            charge(s - t)
            t = s
            turn(kind, name)
        charge(end - t)
    return dict(out)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, CUDA activity included when
    there is a card, written as ``trace_<time>.json`` (Chrome trace format)
    into ``log_dir``, beside ``spans_<time>.json``, its ``span_times``
    (device time by span on the card, host time on the CPU); a no-op when
    ``log_dir`` is empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    stamp = time.strftime('%Y%m%d_%H%M%S')
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{stamp}.json"))
    with open(os.path.join(log_dir, f"spans_{stamp}.json"), "w") as f:
        json.dump({"unit": "us", "spans": span_times(trace_events(prof))},
                  f, indent=1)
