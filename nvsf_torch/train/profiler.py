"""Stage timers and the device trace (counterpart of
``nvsf_tpu/train/profiler.py``): ``PhaseTimers`` accumulates wall time by
stage, and ``device_trace`` records a ``torch.profiler`` trace of the
card (and the host) into a Chrome trace file."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Callable, Optional

import torch


class PhaseTimers:
    """Accumulating wall-clock timers by stage name.

        with timers.phase("render"): ...
        print(timers.report())

    ``sync`` (``torch.cuda.synchronize`` for a trainer on the card) runs
    before each stage's clock stops, so that work queued on the device is
    charged to the stage that queued it. ``last`` holds each stage's most
    recent time."""

    def __init__(self, sync: Optional[Callable[[], None]] = None):
        self.sync = sync
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.last = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            self.last[name] = time.perf_counter() - t0
            self.totals[name] += self.last[name]
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"  {name:24s} {t:8.3f}s  ({n}x, "
                         f"{t / max(n, 1) * 1e3:7.2f} ms/it)")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` trace of the block, CUDA activity included when
    there is a card, written as ``trace_<time>.json`` (Chrome trace format)
    into ``log_dir``; a no-op when ``log_dir`` is empty."""
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
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}"
                              f".json"))
