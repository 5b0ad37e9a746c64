"""Constant tensors made once per device.

A tensor built from host data (``torch.tensor`` of a list, a tuple index)
is a copy from the host: a host synchronisation in an eager step, and an
error inside a step captured as a CUDA graph (``train/step_graph.py``). The
step's constants come from here instead, built at their first use (an
eager warm-up step) and shared after; callers must not write into them.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(values, dtype, device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype, device)``, made once: ``values`` is a
    number or a (nested) tuple of numbers."""
    return _constant(values, dtype, torch.device(device))
