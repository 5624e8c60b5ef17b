"""Build and bind the CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, and bound with ``ctypes``.
Libraries go to ``build/kernels/`` beside the package (a directory git
ignores), named by a digest of the sources and flags, so a changed source
is rebuilt and an unchanged one is loaded as it is. Nothing is built or
loaded when this module is imported: the first call that needs a library
builds it, and ``build_all`` builds every one in parallel (one ``nvcc``
per source, all started together).

Every entry point returns ``cudaGetLastError()``; ``call`` raises when it
is not 0, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per-library flags beside NVCC_FLAGS: the expression interpreter must not
# contract a*b+c into an FMA, which would change float results against
# numpy and XLA
EXTRA_FLAGS: Dict[str, List[str]] = {"fused": ["-fmad=false"]}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# library -> {entry point: argtypes}; every entry point returns an int
LIBRARIES: Dict[str, Dict[str, list]] = {
    "probe_insert": {
        "rw_probe_insert": [_P, _L, _L, _P, _L, _L, _I, _I, _P, _P, _I, _I,
                            _P, _P, _P, _I, _P],
        "rw_lookup": [_P, _L, _P, _L, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                      _I, _P],
    },
    "agg_apply": {
        "rw_agg_apply": [_I, _P, _I, _I, _I, _I, _L, _P, _L, _P, _L, _L,
                         _P, _I, _I, _P],
        "rw_agg_carry": [_P, _L, _L, _P, _I, _I, _P],
    },
    "flush": {
        "rw_flush_gather": [_P, _P, _P, _L, _I, _I, _I, _P, _P, _I, _I, _P,
                            _I, _P],
        "rw_advance": [_P, _L, _I, _I, _P, _I, _I, _I, _P, _I, _P],
    },
    "rebuild": {
        "rw_live_mask": [_I, _P, _P, _P, _L, _I, _I, _I, _I, _L, _I, _P,
                         _P, _P, _P, _L, _P],
        "rw_remap": [_P, _L, _P, _P, _L, _P, _I, _I, _P, _P],
    },
    "scatter": {
        "rw_scatter_rows": [_P, _L, _L, _P, _L, _I, _P, _I, _P, _L, _I, _P],
    },
    "join_apply": {
        "rw_join_apply": [_P, _L, _P, _L, _L, _I, _P, _L, _L, _P, _L, _L,
                          _I, _P, _L, _L, _I, _P, _L, _L, _P, _L, _L, _I,
                          _I, _I, _P, _L, _P, _P, _P, _L, _P, _P,
                          ctypes.c_uint, _P, _P],
    },
    "join_probe": {
        "rw_join_probe": [_P, _L, _L, _I, _P, _L, _L, _I, _P, _L, _L, _P,
                          _I, _I, _P, _L, _L, _P, _L, _L, _P, _P, _L, _P,
                          _P, _P, _P, _L, _P, _I, _P, _P, _P, _L, _I, _I,
                          _I, _P, _L, _I, _P, _P, _P],
    },
    "join_maint": {
        "rw_masked_scatter": [_I, _P, _L, _I, _P, _L, _P, _L, _P, _L, _L,
                              _I, _P],
        "rw_rebase": [_P, _P, _L, _P],
    },
    "fused": {
        "rw_fused_chain": [_P, _P, _I, _P, _L, _I, _P, _P, _I, _P, _P],
        "rw_agg_prelude": [_P, _P, _I, _P, _L, _I, _P, _P, _I, _P, _L, _P],
        "rw_join_prelude": [_P, _P, _I, _P, _L, _I, _P, _P, _I, _P, _P],
    },
    "route": {
        "rw_route": [_P, _L, _P, _L, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                     _P, _P],
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_chain: Dict[tuple, torch.Tensor] = {}


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "a machine with the CUDA toolkit")


def _sources(name: str) -> List[str]:
    return [os.path.join(CSRC, f"{name}.cu"),
            os.path.join(CSRC, "common.cuh")]


def lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS
                                + EXTRA_FLAGS.get(name, [])).encode())
    for p in _sources(name):
        with open(p, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:12]}.so")


def _start_build(name: str) -> Optional[tuple]:
    """Start nvcc for one library unless it is built; returns
    (process, tmp path, final path, log path) or None."""
    out = lib_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = f"{out}.log"
    cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), "-I", CSRC,
           "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    with open(log, "w") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish_build(name: str, job: tuple) -> None:
    proc, tmp, out, log = job
    rc = proc.wait()
    if rc != 0:
        with open(log) as f:
            raise RuntimeError(f"nvcc failed for {name} (rc={rc}):\n"
                               + f.read())
    os.replace(tmp, out)


def build_all() -> Dict[str, float]:
    """Build every library, one nvcc per source, all started together.
    Returns seconds from start to each library's finish (0.0 when it was
    already built)."""
    t0 = time.perf_counter()
    jobs = {name: _start_build(name) for name in LIBRARIES}
    took: Dict[str, float] = {}
    for name, job in jobs.items():
        if job is not None:
            _finish_build(name, job)
        took[name] = time.perf_counter() - t0 if job is not None else 0.0
    return took


def build_log(name: str) -> str:
    """The nvcc output (with ptxas register/spill lines) of a library."""
    log = f"{lib_path(name)}.log"
    if not os.path.isfile(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The bound library, built first when it is missing."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(lib_path(name))
        for fn, argtypes in LIBRARIES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.rw_error_string.argtypes = [ctypes.c_int]
        lib.rw_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
        return lib


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def _chain_key(device: torch.device, tag: str) -> tuple:
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return index, stream_ptr(), tag


def stats_chain(device: torch.device, n: int,
                tag: str = "stats") -> Tuple[torch.Tensor, torch.Tensor]:
    """(stats, next) for a kernel that sums its stats in its own launch
    (K1, K8), or keeps its scan's ticket and status words there (K3's
    gather, tag "flush"): ``stats`` is ``n`` zeroed int32 words to sum
    into, and ``next`` a block the launch must zero for the launch after
    it on the same stream and chain, handed on by ``chain_next`` once the
    launch went out. Launches of one stream run one after another, so each
    launch's words were zeroed by the one before it in its chain; the
    first launch, one after a launch that failed, and one that needs more
    words than were zeroed get a fresh zeroed block. Each block is handed
    out once."""
    cur = _chain.pop(_chain_key(device, tag), None)
    if cur is None or cur.numel() < n:
        cur = torch.zeros(max(n, 64), dtype=torch.int32, device=device)
    nxt = torch.empty(max(n, 64), dtype=torch.int32, device=device)
    return cur[:n], nxt


def chain_next(device: torch.device, nxt: torch.Tensor,
               tag: str = "stats") -> None:
    """After a launch that zeroes ``nxt``: the next launch's words."""
    _chain[_chain_key(device, tag)] = nxt


def call(name: str, fn: str, *args) -> None:
    """Launch through one entry point on the current stream; raise on a
    non-zero CUDA error code."""
    lib = load(name)
    rc = getattr(lib, fn)(*args, stream_ptr())
    if rc != 0:
        msg = lib.rw_error_string(rc).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {rc} ({msg})")

