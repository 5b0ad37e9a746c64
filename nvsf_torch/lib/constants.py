"""Constant tensors made once per device.

A tensor built from host data (``torch.tensor`` of a list, a tuple index)
is a copy from the host: a host synchronisation in an eager step, and an
error inside a step captured as a CUDA graph (``train/step_graph.py``). The
step's constants come from here instead, built at their first use (an
eager warm-up) and shared after; callers must not write into them. On the
card a constant is copied from pinned memory without waiting for the
device, so that making one raises nothing under
``torch.cuda.set_sync_debug_mode("error")`` (the frame graphs' warm-up,
``render/frame_graph.py``).
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    host = torch.tensor(values, dtype=dtype)
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)``, made once: ``values`` is a
    number or a (nested) tuple of numbers."""
    return _constant(values, dtype, torch.device(device))
