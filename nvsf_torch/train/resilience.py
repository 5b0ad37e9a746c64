"""Failure recovery: training epochs retried after the card ran out of
memory, by freeing its cached memory and reloading the latest checkpoint
(counterpart of ``nvsf_tpu/train/resilience.py``).

Only ``torch.cuda.OutOfMemoryError`` is retried. Other CUDA errors leave
the process's CUDA context broken (a retry in the same process fails
again), and an internal assert is a bug: both propagate. Under a
data-parallel mesh nothing is retried: one rank retrying while the others
wait in a collective would deadlock, so the failure ends every rank (the
JAX package, one process over all its devices, retries there)."""

from __future__ import annotations

import time
from typing import Callable

import torch


def is_recoverable(err: Exception) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError)


def run_epochs_with_recovery(trainer, first_epoch: int, last_epoch: int,
                             on_epoch: Callable[[int, object], None],
                             max_restarts: int = 3,
                             backoff_s: float = 30.0, log_fn=print):
    """Run trainer epochs first..last, ``on_epoch(epoch, stats)`` after
    each (eval and checkpoint hooks); on a recoverable failure, free the
    card's cached memory (the trainer's captured steps dropped first) and
    restart from the latest checkpoint (never under the trainer's mesh). Each restart logs a line starting
    ``[recovery]``."""
    restarts = 0
    ep = first_epoch
    while ep <= last_epoch:
        try:
            trainer.epoch = ep
            stats = trainer.train_one_epoch()
            on_epoch(ep, stats)
            ep += 1
        except Exception as err:  # noqa: BLE001 — classified below
            if (not is_recoverable(err) or restarts >= max_restarts
                    or getattr(trainer, "mesh", None) is not None):
                raise
            restarts += 1
            if log_fn:
                log_fn(f"[recovery] epoch {ep} failed "
                       f"({type(err).__name__}); restart "
                       f"{restarts}/{max_restarts} in {backoff_s:.0f}s")
            time.sleep(backoff_s)
            # the captured steps hold their memory pool: drop them first
            trainer.drop_step_graphs()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            if trainer.load_checkpoint("latest"):
                ep = trainer.epoch + 1
                if log_fn:
                    log_fn(f"[recovery] restored checkpoint at epoch "
                           f"{trainer.epoch}; resuming from {ep}")
            elif log_fn:
                log_fn("[recovery] no checkpoint found; retrying epoch "
                       f"{ep} with in-memory state")
    return trainer
