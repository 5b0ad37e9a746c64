"""A traced window: ``torch.profiler`` (CPU and CUDA activities) around
the window's calls, reduced to the device's kernels (name, start, length),
their busy time (the union of their intervals), the window's wall time,
and a breakdown: the kernel families that took most device time and the
longest idle gaps of the device, each named by the host operation that
was running in it."""

from __future__ import annotations

import time
from typing import List, Tuple

import torch

from perfbench import yardstick as ys


def _raw_events(prof):
    """(name, start_us, dur_us, on_device) of every recorded event."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            dev = e.device_type() == torch.autograd.DeviceType.CUDA
            out.append((e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3,
                        dev))
        return out
    except AttributeError:
        pass
    for e in prof.events():
        dev = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((e.name, e.time_range.start, e.time_range.elapsed_us(),
                    dev))
    return out


def union(intervals: List[Tuple[float, float]]):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


class Window:
    """``with Window(device) as w: ...`` traces the block; afterwards
    ``w.kernels`` [(name, start_us, dur_us)], ``w.busy_s``, ``w.wall_s``."""

    def __init__(self, device):
        self.device = torch.device(device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        ev = _raw_events(self.prof)
        self.kernels = [(n, s, d) for n, s, d, dev in ev
                        if dev and d > 0 and not n.startswith("Memcpy")
                        and not n.startswith("Memset")]
        self.device_ops = [(n, s, d) for n, s, d, dev in ev if dev and d > 0]
        self.host_ops = [(n, s, d) for n, s, d, dev in ev if not dev]
        iv = union([(s, s + d) for _, s, d in self.device_ops])
        self.busy_s = sum(e - s for s, e in iv) / 1e6
        self.intervals = iv
        del self.prof
        return False

    def kernel_time_s(self, names) -> float:
        """Device seconds of the kernels whose names contain one of
        ``names``."""
        return sum(d for n, _, d in self.kernels
                   if any(k in n for k in names)) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        fams = {}
        for n, _, d in self.device_ops:
            f = ys.family(n)
            fams[f] = fams.get(f, 0.0) + d / 1e6
        ops = sorted(fams.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        iv = self.intervals
        for (s0, e0), (s1, _) in zip(iv, iv[1:]):
            gaps.append((s1 - e0, e0, s1))
        gaps.sort(reverse=True)
        named = []
        for g, a, b in gaps[:top]:
            mid = 0.5 * (a + b)
            host = [(d, n) for n, s, d in self.host_ops if s <= mid <= s + d]
            # the innermost host operation running at the gap's middle
            what = min(host)[1] if host else "host idle"
            named.append([what, g / 1e6])
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
