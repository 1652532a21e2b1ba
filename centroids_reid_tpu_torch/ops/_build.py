"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``): the one
place that knows how a hand-written kernel (K1-K9) is called.

``nvcc`` compiles each source for ``sm_90a`` (Hopper), all at once in
parallel processes, and links the objects into one shared library with a
plain C interface, which ``ctypes`` loads. The library is built at first use
into ``ops/_build/`` (listed in ``.gitignore``), under a name keyed on a
hash of every file under ``csrc/`` (the sources and the headers they
include) and the compiler flags, so an edited source or header is rebuilt
and an unchanged tree is reused.

A wrapper takes its plain version for CPU tensors (``on_cpu``) and for CUDA
tensors checks its operands, then calls ``launch``: the library's entry
point ``crt_<name>`` on the current stream, without a synchronise, a raise
on a non-zero return and one more in ``LAUNCHES[name]``. K5 and K6 are
also PyTorch operators on ``LIB`` (``torch.ops.crt``), only because
``torch.export`` records an operator as one node of a program
(``inference/export.py``) where it cannot follow a ``ctypes`` call.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Optional

import torch

_CSRC = os.path.join(os.path.dirname(__file__), "csrc")
_SOURCES = ("retrieval.cu", "retrieval_int8.cu", "int8_conv.cu",
            "stream_rank.cu", "add_norm.cu", "window_attn.cu")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_ABI_VERSION = 10

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


def _csrc_files() -> list:
    """Every file under ``csrc/`` that the build reads: the sources and the
    headers they include, by name."""
    return sorted(n for n in os.listdir(_CSRC)
                  if n.endswith((".cu", ".cuh", ".h")))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.crt_abi_version.restype = i
    lib.crt_abi_version.argtypes = []
    lib.crt_sm_count.restype = i
    lib.crt_sm_count.argtypes = []
    lib.crt_scores.restype = i
    lib.crt_scores.argtypes = [p, p, p, p, i, i, i, p]
    lib.crt_stream_topk.restype = i
    lib.crt_stream_topk.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
    lib.crt_stream_topk_unpacked.restype = i
    lib.crt_stream_topk_unpacked.argtypes = [p, p, p, p, p, p, i, i, i, i, i,
                                             p]
    lib.crt_kpass_topk.restype = i
    lib.crt_kpass_topk.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.crt_scores_i8.restype = i
    lib.crt_scores_i8.argtypes = [p, p, p, p, p, i, i, i, i, p]
    lib.crt_requant_smem_bytes.restype = i
    lib.crt_requant_smem_bytes.argtypes = [i, i]
    lib.crt_matmul_requant.restype = i
    lib.crt_matmul_requant.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i,
                                       p]
    lib.crt_conv3x3_requant.restype = i
    lib.crt_conv3x3_requant.argtypes = [p, p, p, p, p, p, i, p, i, i, i, i, i,
                                        i, i, p]
    for name in ("crt_stream_extract", "crt_stream_count"):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = [p] * 11 + [i] * 7 + [p]
    lib.crt_add_norm.restype = i
    lib.crt_add_norm.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i,
                                 ctypes.c_float, p]
    lib.crt_window_attn.restype = i
    lib.crt_window_attn.argtypes = [p, p, p, ctypes.c_longlong, i, i, p, p,
                                    i, i, i, i, i, i, p]


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
        for name in _csrc_files():
            h.update(name.encode())
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


# kernel launches since the last reset (``ops.launch_counts``), by name
LAUNCHES: Dict[str, int] = dict.fromkeys((
    "scores", "stream_topk", "stream_topk_unpacked", "kpass_topk",
    "scores_i8", "matmul_requant", "conv3x3_requant", "stream_extract",
    "stream_count", "add_norm", "window_attn"), 0)

# the operators ``torch.ops.crt.*`` (K5 and K6, ``int8_conv.py``)
LIB = torch.library.Library("crt", "FRAGMENT")


def on_cpu(*tensors: Optional[torch.Tensor]) -> bool:
    """True: all on the CPU (plain path). False: all on the current CUDA
    device (kernel path). Anything else raises. None is skipped."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(
            f"tensors on different devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no CUDA kernel for device {dev}")
    if dev.index is not None and dev.index != torch.cuda.current_device():
        # the kernels launch on the current device's current stream
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return False


def check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """Refuse tensors that are not contiguous or do not start on a 16-byte
    boundary (the kernels' 16-byte, TMA and cp.async loads)."""
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what} must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} must start on a 16-byte boundary")


def aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and on a 16-byte boundary, copied where it is not."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """The SM count of CUDA device ``device_index``, read once."""
    with torch.cuda.device(device_index):
        sms = load().crt_sm_count()
    if sms < 1:
        raise RuntimeError(f"cannot read the SM count of cuda:{device_index}")
    return sms


def launch(name: str, *args) -> None:
    """Call ``crt_<name>(*args, stream)`` on the current device's current
    stream, raise if it returns an error, and count the launch."""
    # the raw handle, without building a Stream object: 0.2 against 7.9 us
    # of host time a call
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = getattr(load(), f"crt_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1
