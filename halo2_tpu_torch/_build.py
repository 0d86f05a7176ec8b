"""Build the port's CUDA kernels from `csrc/` at first use and bind them.

All kernel sources compile in ONE `nvcc` call into a shared library with a
plain C interface (no PyTorch headers, so the build takes seconds), which
is loaded with `ctypes`.  The library lands in `halo2_tpu_torch/_build/`
under a name keyed by the hash of the sources and flags, so a later process
reuses it and an edited source rebuilds.

Each entry point is a `Kernel`: the wrapper that launches it counts its
launches (`Kernel.launches`), and a non-zero `cudaGetLastError()` returned
by the C function raises.  One C entry point that dispatches to several
`__global__` functions is bound once per function, under its own name, so
each is counted on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("field.cu", "ec.cu", "ntt.cu", "msm.cu")
HEADERS = ("bn254.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_LIB = None
build_seconds = None     # wall time of this process's build (None: reused)
KERNELS: dict = {}       # name -> Kernel


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def library() -> ctypes.CDLL:
    """The kernel library, built on first call in this checkout."""
    global _LIB, build_seconds
    with _LOCK:
        if _LIB is None:
            os.makedirs(BUILD_DIR, exist_ok=True)
            so = os.path.join(BUILD_DIR, f"libhalo2_kernels_{_digest()}.so")
            if not os.path.exists(so):
                t0 = time.time()
                tmp = f"{so}.tmp{os.getpid()}"
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       *[os.path.join(CSRC, s) for s in SOURCES]]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        "nvcc failed:\n" + res.stdout + res.stderr)
                os.replace(tmp, so)
                build_seconds = time.time() - t0
            lib = ctypes.CDLL(so)
            lib.h2_error_string.argtypes = [ctypes.c_int]
            lib.h2_error_string.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB


class Kernel:
    """One kernel behind a C entry point of the library, plus its launch
    count; `name` defaults to the symbol."""

    def __init__(self, symbol: str, argtypes, name: str = None):
        self.symbol = symbol
        self.name = name or symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None
        KERNELS[self.name] = self

    def launch(self, *args):
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            msg = library().h2_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc}: {msg}")
        self.launches += 1


def reset_launch_counts():
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on t's device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
