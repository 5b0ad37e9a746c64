"""Build, load and count the package's hand-written CUDA kernels.

The sources in ``nvsf_torch/csrc/*.cu`` have a plain C interface (the
``*.cuh`` headers beside them are shared helpers). At first use each is
compiled with ``nvcc`` for ``sm_90a`` into an object file, all
of them at once in parallel, and the objects are linked into one shared
library under ``build/nvsf_torch_kernels/<hash of sources and flags>/`` at
the root of the checkout, which is loaded with ``ctypes``. Nothing is
built when a module is imported, so the package imports on machines
without ``nvcc``.

``LAUNCHES`` counts kernel launches by kernel name; each wrapper adds one
where it launches its kernel, and nowhere else. ``segment_add`` counts
every launch of the segment-add kernel, ``segment_add_f32`` those of its
f32 variant (B2) again, both through its cols/vals entry
(``nvsf_segment_add``); ``hash_encode_fwd`` the hash-grid lookup's
forward (``csrc/hash_encode.cu``), ``hash_encode_bwd`` its gradient (the
segment-add kernel's rows stage through the lookup's entry,
``nvsf_hash_encode_bwd``, in either precision); ``graph_if`` the conditional IF nodes that the
frame graphs capture (``csrc/graph_cond.cu``, each with a one-thread
kernel that sets the node's condition). The span markers
(``csrc/spans.cu``, launched by ``train/profiler.py``) are not counted.
A launch inside the body of an IF node runs only where the device decides
so: the body adds it to a counter on the device
(``device_launch_counter``), and ``launch_counts`` reads those counters
into ``LAUNCHES``. Read the counts through ``launch_counts()``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "nvsf_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"segment_add": 0, "segment_add_f32": 0, "multihot_fwd": 0,
            "multihot_bwd": 0, "chamfer_min_dist": 0, "graph_if": 0,
            "hash_encode_fwd": 0, "hash_encode_bwd": 0}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_SIGNATURES = {
    "nvsf_segment_add": (_P, _P, _I64, _P, _P, _I64, _I64, _I, _I, _P),
    "nvsf_hash_encode_fwd": (_P, _I, _P, _I, _I, _I, _P),
    "nvsf_hash_encode_bwd": (_P, _I, _P, _I, _I, _I, _P, _P, _I64, _I, _P),
    "nvsf_multihot_fwd": (_P, _I64, _P, _P, _P, _I64, _I, _I, _I, _I64, _P),
    "nvsf_multihot_bwd": (_P, _I64, _P, _P, _P, _P, _P, _I64, _I, _I, _I,
                          _I64, _P),
    "nvsf_min_dist2": (_P, _I64, _P, _P, _I64, _P, _P),
    "nvsf_graph_begin_if": (_P, _P, _P, _I),
    "nvsf_graph_end_if": (_P,),
    "nvsf_span_mark": (_P, _I, _I),
}

_lock = threading.Lock()
_lib = None
build_info = {}


# counters on the device, int64 [len(LAUNCHES)] in the order of LAUNCHES
_DEVICE_COUNTS = weakref.WeakValueDictionary()     # id -> counter


def device_launch_counter(device):
    """A zeroed counter of launches on ``device`` that ``launch_counts``
    reads: the work that launches adds its launches to it on the device."""
    import torch
    counter = torch.zeros(len(LAUNCHES), dtype=torch.int64, device=device)
    _DEVICE_COUNTS[id(counter)] = counter
    return counter


def launch_counts() -> dict:
    """``LAUNCHES`` with the device counters' launches moved into it (a
    host read of each counter, which waits for the work queued before)."""
    for counter in list(_DEVICE_COUNTS.values()):
        for k, n in zip(LAUNCHES, counter.tolist()):
            LAUNCHES[k] += n
        counter.zero_()
    return dict(LAUNCHES)


def reset_launch_counts() -> None:
    for counter in list(_DEVICE_COUNTS.values()):
        counter.zero_()
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _build(flags=NVCC_FLAGS, csrc=CSRC) -> Path:
    srcs = sorted(csrc.glob("*.cu"))
    h = hashlib.sha256(" ".join(flags).encode())
    for s in sorted(csrc.glob("*.cu*")):      # sources and headers
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    so = out_dir / "libnvsf_torch_kernels.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, log="(cached)")
        return so
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f".tmp.{os.getpid()}"
    objs = [out_dir / f"{s.stem}{tag}.o" for s in srcs]
    t0 = time.perf_counter()
    procs = [(subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(s)],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT, text=True), s)
             for s, o in zip(srcs, objs)]
    log, failed = "", []
    for proc, src in procs:
        out, _ = proc.communicate()
        log += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = out_dir / f"lib{tag}.so"
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      log=log)
    return so


def build_library(flags=NVCC_FLAGS, csrc=CSRC) -> ctypes.CDLL:
    """Build (or find in the cache) and load the kernels compiled with
    ``flags`` from the sources in ``csrc``. The package uses ``library()``;
    other flags and sources (with the same C interface) are for measuring
    variants of the kernels (``tools/``)."""
    lib = ctypes.CDLL(str(_build(flags, Path(csrc))))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nvsf_error_string.argtypes = (ctypes.c_int,)
    lib.nvsf_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = build_library()
    return _lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.nvsf_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, t, dtype, ndim: int) -> None:
    """Check a tensor handed to a kernel: device, dtype, rank, layout."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
