"""Ray-sharded data parallelism over ``torch.distributed`` (counterpart of
``nvsf_tpu/parallel/mesh.py``).

A mesh is one process per rank, all of them running one global step split
by rays. Every rank makes the same random draws at the batch's full shape
(the step's generator has the same seed everywhere), renders its own
contiguous slice of the rays (``shard_rays``), gathers the per-ray outputs
that the losses read onto every rank (``gather_rays``) and computes the
whole batch's loss. The gather's backward hands each rank the rank count
times its share of the loss gradient, and the mean over the ranks
(``all_reduce_grads``) divides that back out: the result is the whole
batch's gradient, as the ``psum`` that XLA inserts into the JAX package's
sharded step. Parameters stay identical on every rank because every rank
applies Adam to the same gradient; state whose update writes through
duplicate indices (error maps, occupancy grids) is broadcast from rank 0
after each update (``replicate``).

Every collective is an ``all_reduce`` or a ``broadcast``: gloo supports
only these two for CUDA tensors, so one code path serves NCCL (one rank to
a card) and gloo (ranks on the CPU, or several ranks sharing one card).
Each ``Mesh`` counts the collectives it issued (``Mesh.collectives``):
calls and bytes by kind.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Dict, Iterable, List, Optional

import torch
import torch.distributed as dist

# gradient bytes all-reduced at once: a few buckets for the shipped widths
# (369 MiB of f32 gradients at bench.py's joint-tuned rung)
BUCKET_BYTES = 64 << 20


@dataclass
class Mesh:
    """This process's place in a 1-D data mesh: ``world_size`` ranks over
    the default process group, this one ``rank``, on ``device``."""
    world_size: int
    rank: int
    device: torch.device
    collectives: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def bounds(self, n: int):
        """[lo, hi) of this rank's rays of an n-ray batch: contiguous
        slices of ceil(n / world_size), the last ones shorter or empty (the
        split XLA makes of an uneven sharded dimension)."""
        per = -(-n // self.world_size)
        lo = min(self.rank * per, n)
        return lo, min(lo + per, n)

    def _count(self, kind: str, t: torch.Tensor) -> None:
        c = self.collectives.setdefault(kind, {"calls": 0, "bytes": 0})
        c["calls"] += 1
        c["bytes"] += t.numel() * t.element_size()

    def all_reduce(self, t: torch.Tensor, kind: str) -> None:
        """Sum ``t`` over the ranks, in place."""
        self._count(f"all_reduce {kind}", t)
        dist.all_reduce(t)

    def broadcast(self, t: torch.Tensor, kind: str) -> None:
        """Rank 0's ``t`` into ``t`` on every rank."""
        self._count(f"broadcast {kind}", t)
        dist.broadcast(t, src=0)

    def barrier(self) -> None:
        self.all_reduce(torch.zeros(1, device=self.device), "barrier")

    def close(self) -> None:
        dist.destroy_process_group()


def mesh_from_spec(spec: str) -> int:
    """Ranks of a non-empty ``mesh_shape`` string: "8" -> 8, "4x2" -> 8
    (the axes fold into the one data axis, as in the JAX package)."""
    dims = [int(x) for x in spec.lower().split("x")]
    if min(dims) < 1:
        raise ValueError(f"mesh_shape={spec!r}: every axis must be >= 1")
    return math.prod(dims)


def make_mesh(rank: int, world_size: int, init_method: str,
              device="cuda", backend: Optional[str] = None,
              timeout: float = 600.0) -> Mesh:
    """Join the default process group as ``rank`` of ``world_size``.
    ``device`` "cuda" puts rank r on ``cuda:r`` (NCCL by default), an
    indexed "cuda:i" puts the rank there, "cpu" on the CPU (gloo).
    ``timeout`` (seconds) bounds the rendezvous and every collective."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card and "
                               "torch.cuda.is_available() is False")
        if dev.index is None:
            dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout))
    return Mesh(world_size, rank, dev)


def shard_rays(mesh: Mesh, *tensors):
    """This rank's slice of each [N, ...] tensor along the rays."""
    n = tensors[0].shape[0]
    if any(t.shape[0] != n for t in tensors):
        raise ValueError(f"ray counts differ: {[t.shape[0] for t in tensors]}")
    lo, hi = mesh.bounds(n)
    return tuple(t[lo:hi] for t in tensors)


class _GatherRays(torch.autograd.Function):
    """Each rank's slice written at its offset into zeros of the global
    length, summed over the ranks; the backward sums the incoming gradient
    over the ranks and returns this rank's slice (the contract of
    ``torch.distributed.nn.functional.all_gather``, on ``all_reduce``)."""

    @staticmethod
    def forward(ctx, x, mesh, n):
        lo, hi = mesh.bounds(n)
        if x.shape[0] != hi - lo:
            raise ValueError(f"rank {mesh.rank} holds {x.shape[0]} rays of "
                             f"{n}; its slice is [{lo}, {hi})")
        out = x.new_zeros((n,) + tuple(x.shape[1:]))
        out[lo:hi] = x
        mesh.all_reduce(out, "gather_rays")
        ctx.mesh, ctx.lo, ctx.hi = mesh, lo, hi
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.mesh.all_reduce(g, "gather_rays backward")
        return g[ctx.lo:ctx.hi], None, None


def gather_rays(mesh: Mesh, x: torch.Tensor, n: int) -> torch.Tensor:
    """Every rank's slice of an ``n``-ray tensor, whole on every rank."""
    return _GatherRays.apply(x, mesh, n)


@torch.no_grad()
def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor],
              kind: str = "replicate") -> None:
    """Rank 0's values of ``tensors`` (parameters, buffers, state) into
    them on every rank, in place."""
    for t in tensors:
        mesh.broadcast(t.detach(), kind)


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params: Iterable[torch.Tensor]) -> None:
    """Replace each parameter's gradient by its mean over the ranks (a
    missing gradient counts as zeros), in flat buckets of about
    ``BUCKET_BYTES``."""
    params = list(params)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    buckets, size = [[]], 0
    for p in params:
        b = buckets[-1]
        if b and (size + p.grad.nbytes > BUCKET_BYTES
                  or p.grad.dtype != b[0].grad.dtype):
            buckets.append([])
            size = 0
        buckets[-1].append(p)
        size += p.grad.nbytes
    for b in buckets:
        if not b:
            continue
        flat = torch.cat([p.grad.reshape(-1) for p in b])
        mesh.all_reduce(flat, "grads")
        flat.div_(mesh.world_size)
        for p, g in zip(b, flat.split([p.numel() for p in b])):
            p.grad.copy_(g.view_as(p.grad))


@torch.no_grad()
def replicas_differ(mesh: Mesh, named: Dict[str, torch.Tensor]) -> List[str]:
    """Names of the tensors whose bits on this rank differ from rank 0's
    (broadcast under the kind "check")."""
    def bits(a):
        return a.detach().contiguous().reshape(-1).view(torch.uint8)

    bad = []
    for name, t in named.items():
        ref = t.detach().clone()
        mesh.broadcast(ref, "check")
        if not torch.equal(bits(ref), bits(t)):
            bad.append(name)
    return bad


def _rank_main(fn, rank, world_size, init_method, device, backend, timeout,
               threads, results, args):
    if threads:
        torch.set_num_threads(threads)
    try:
        mesh = make_mesh(rank, world_size, init_method, device, backend,
                         timeout)
        try:
            value = fn(mesh, *args)
        finally:
            mesh.close()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    # by value: tensors would otherwise travel as handles to shared memory
    # that the rank's exit frees
    results.put((rank, True, pickle.dumps(value)))


def spawn(fn, world_size: int, args=(), *, device="cuda",
          backend: Optional[str] = None,
          timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks, each a process
    started with the ``spawn`` method (``fn`` and ``args`` are pickled),
    meeting through a ``file://`` store in a temporary directory; returns
    their return values by rank. ``device`` and ``backend`` are
    ``make_mesh``'s. A rank that raises or dies, or a run longer than
    ``timeout`` seconds, ends every rank and raises here; the process
    group's own timeout (rendezvous and each collective) is ``timeout``,
    or 30 minutes without one. Ranks on the CPU share this process's
    torch threads."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="nvsf_mesh_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    threads = (max(1, torch.get_num_threads() // world_size)
               if torch.device(device).type == "cpu" else 0)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world_size, init, str(device), backend, timeout or 1800.0,
        threads, results, tuple(args))) for r in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        dead_since = None
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"mesh of {world_size} ranks: ranks "
                        f"{sorted(set(range(world_size)) - set(out))} did "
                        f"not finish within {timeout:.0f} s") from None
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode is not None]
                if dead:
                    # give a result already written a moment to arrive
                    dead_since = dead_since or time.monotonic()
                    if time.monotonic() - dead_since > 5.0:
                        raise RuntimeError(
                            f"mesh ranks {dead} exited (codes "
                            f"{[procs[r].exitcode for r in dead]}) without "
                            "a result") from None
                continue
            if not ok:
                raise RuntimeError(f"mesh rank {rank} of {world_size} "
                                   f"failed:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=60.0)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"mesh ranks exited with codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world_size)]
