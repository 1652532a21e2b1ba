"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source for ``sm_90a`` (Hopper), all at once in
parallel processes, and links the objects into one shared library with a
plain C interface, which ``ctypes`` loads. The library is built at first use
into ``ops/_build/`` (listed in ``.gitignore``), under a name keyed on a
hash of the sources and the compiler flags, so an edited source is rebuilt
and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_SOURCES = ("retrieval.cu", "retrieval_int8.cu", "int8_conv.cu")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_ABI_VERSION = 2

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# what the last build printed (ptxas register/smem report) and took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
        "compiled from source on first use on a CUDA machine"
    )


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crt_abi_version.restype = i
    lib.crt_abi_version.argtypes = []
    lib.crt_scores.restype = i
    lib.crt_scores.argtypes = [p, p, p, p, i, i, i, p]
    lib.crt_stream_topk.restype = i
    lib.crt_stream_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.crt_kpass_topk.restype = i
    lib.crt_kpass_topk.argtypes = [p, p, p, i, i, i, p]
    lib.crt_scores_i8.restype = i
    lib.crt_scores_i8.argtypes = [p, p, p, p, p, i, i, i, p]
    lib.crt_matmul_requant.restype = i
    lib.crt_matmul_requant.argtypes = [p, p, p, p, p, p, i, p, i, i, i, p]
    lib.crt_conv3x3_requant.restype = i
    lib.crt_conv3x3_requant.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i,
                                        p]


def _compile(so: str) -> str:
    """One nvcc process per source, all started together, then one link.
    Returns what the compilers printed; raises if any step fails."""
    tmp = f"{so}.build{os.getpid()}"
    objs = [f"{tmp}.{n}.o" for n in _SOURCES]
    procs = [
        subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", obj,
                          os.path.join(_CSRC, name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for name, obj in zip(_SOURCES, objs)
    ]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(outs)
    failed = [n for n, proc in zip(_SOURCES, procs) if proc.returncode != 0]
    if not failed:
        proc = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed = ["link"]
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
    os.replace(tmp, so)  # atomic against a concurrent build
    return log


def load() -> ctypes.CDLL:
    """The kernel library, built on first call (thread-safe)."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(_FLAGS).encode())
        for name in _SOURCES:
            with open(os.path.join(_CSRC, name), "rb") as f:
                h.update(f.read())
        so = os.path.join(_BUILD_DIR, f"crt_kernels_{h.hexdigest()[:16]}.so")
        if not os.path.exists(so):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            build_log = _compile(so)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(so)
        _declare(lib)
        if lib.crt_abi_version() != _ABI_VERSION:
            raise RuntimeError(f"{so}: unexpected kernel ABI version")
        _lib = lib
    return _lib
