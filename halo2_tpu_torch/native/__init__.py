"""Native host library: compile-on-demand C++ for the verifier-side
primitives the reference gets from compiled Rust (halo2curves pairing,
sha3 Keccak-256).  The card runs the prover's array math; these host-side
scalar primitives run as -O3 native code instead of Python big-int loops.

Gracefully degrades: if the toolchain or the built .so is unavailable,
callers fall back to the pure-Python implementation (compat/bn254_pairing.py).
The library builds with g++ into the package's `_build/native/`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "src", "bn254.cpp")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _cache_dir() -> str:
    """The package's ignored build directory (built once per checkout)."""
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def _build() -> Optional[str]:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"libhalo2native-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
           "-o", tmp, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError, OSError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (pure-Python fallback)."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.bn254_pairing_check.restype = ctypes.c_int
        lib.bn254_pairing_check.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ]
        lib.bn254_pairing.restype = None
        lib.bn254_pairing.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.keccak256.restype = None
        lib.keccak256.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint8),
        ]
        _LIB = lib
        return _LIB


def _to_words(x: int, n: int = 4) -> List[int]:
    return [(x >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(n)]


def pairing_check(pairs: Sequence[Tuple[Optional[Tuple[int, int]],
                                        Optional[tuple]]]) -> Optional[bool]:
    """prod e(P_i, Q_i) == 1 with P affine G1 ints, Q ((x0,x1),(y0,y1)) ints.
    Returns None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(pairs)
    g1 = (ctypes.c_uint64 * (8 * n))()
    g2 = (ctypes.c_uint64 * (16 * n))()
    inf = (ctypes.c_uint8 * n)()
    for i, (p, q) in enumerate(pairs):
        if p is None or q is None:
            inf[i] = 1
            continue
        words = _to_words(p[0]) + _to_words(p[1])
        for j, w in enumerate(words):
            g1[8 * i + j] = w
        (x0, x1), (y0, y1) = q
        words = (_to_words(x0) + _to_words(x1) +
                 _to_words(y0) + _to_words(y1))
        for j, w in enumerate(words):
            g2[16 * i + j] = w
    return bool(lib.bn254_pairing_check(g1, g2, inf, n))


def pairing(p: Tuple[int, int], q: tuple) -> Optional[List[int]]:
    """e(P, Q) as 12 canonical Fq coefficients (testing hook)."""
    lib = get_lib()
    if lib is None:
        return None
    g1 = (ctypes.c_uint64 * 8)(*(_to_words(p[0]) + _to_words(p[1])))
    (x0, x1), (y0, y1) = q
    g2 = (ctypes.c_uint64 * 16)(*(_to_words(x0) + _to_words(x1) +
                                  _to_words(y0) + _to_words(y1)))
    out = (ctypes.c_uint64 * 48)()
    lib.bn254_pairing(g1, g2, out)
    coeffs = []
    for i in range(12):
        v = 0
        for j in range(4):
            v |= int(out[4 * i + j]) << (64 * j)
        coeffs.append(v)
    return coeffs


def keccak256(data: bytes) -> Optional[bytes]:
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * 32)()
    lib.keccak256(data, len(data), out)
    return bytes(out)
