"""Native host library: compile-on-demand C++ for the verifier-side
primitives the reference gets from compiled Rust (halo2curves pairing,
sha3 Keccak-256), and the prover's column encoder (`src/encode.cpp`: a
list of python ints to the words of their residues, for
`fields/field.py`).  The card runs the prover's array math; these
host-side scalar primitives run as -O3 native code instead of Python
big-int loops.

Gracefully degrades: if the toolchain or the built .so is unavailable,
callers fall back to the pure-Python implementation (compat/bn254_pairing.py,
`fields.field`'s `to_bytes`).  Each library builds with g++ into the
package's `_build/native/`, named by a hash of its source and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from typing import List, Optional, Sequence, Tuple

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SRC = os.path.join(_SRC_DIR, "bn254.cpp")
_ENCODE_SRC = os.path.join(_SRC_DIR, "encode.cpp")
_LOCK = threading.Lock()
_LOADED: dict = {}      # library name -> the loaded library, or None


def _cache_dir() -> str:
    """The package's ignored build directory (built once per checkout)."""
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", "native")
    os.makedirs(d, exist_ok=True)
    return d


def _build(src: str = _SRC, name: str = "libhalo2native",
           flags: Sequence[str] = ()) -> Optional[str]:
    with open(src, "rb") as f:
        data = f.read()
    tag = hashlib.sha256(data + " ".join(flags).encode()).hexdigest()[:16]
    out = os.path.join(_cache_dir(), f"{name}-{tag}.so")
    if os.path.exists(out):
        return out
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", *flags,
           "-o", tmp, src]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return out
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            FileNotFoundError, OSError):
        return None


def _load(name: str, src: str, flags: Sequence[str], cls, declare):
    """The library `name` built from `src`, loaded once by `cls` and its
    functions declared by `declare`; None where it cannot be built or
    loaded."""
    with _LOCK:
        if name not in _LOADED:
            path = _build(src, name, flags)
            lib = None
            if path is not None:
                try:
                    lib = cls(path)
                except OSError:
                    lib = None
                else:
                    declare(lib)
            _LOADED[name] = lib
        return _LOADED[name]


def _declare_bn254(lib):
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


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None (pure-Python fallback)."""
    return _load("libhalo2native", _SRC, (), ctypes.CDLL, _declare_bn254)


def _declare_encode(lib):
    lib.h2_encode_words.restype = ctypes.c_int
    lib.h2_encode_words.argtypes = [
        ctypes.py_object, ctypes.c_ssize_t, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint64),
    ]


def encode_lib(flags: Sequence[str] = ()) -> Optional[ctypes.PyDLL]:
    """The column encoder's library (`src/encode.cpp`), loaded with
    `ctypes.PyDLL` so that its calls hold the interpreter lock, or None
    (the callers' `to_bytes` fallback).  `flags` are extra g++ flags:
    `("-DH2_ENCODE_API",)` builds the form that reads ints through the C
    API, which a build on CPython 3.12 and 3.13 does not use."""
    name = "libhalo2encode" + "".join(
        f.replace("-D", "_").lower() for f in flags)
    if name in _LOADED:     # no sysconfig lookup on a call per value
        return _LOADED[name]
    return _load(name, _ENCODE_SRC,
                 ("-I" + sysconfig.get_paths()["include"], *flags),
                 ctypes.PyDLL, _declare_encode)


def encode_words(vals: list, rows: int, addr: int,
                 p: Optional[int] = None) -> bool:
    """The first `rows` items of the list `vals`, each reduced mod `p`
    unless p is None, as (rows, 8) int32 little-endian words at `addr`,
    in one native pass.  False, with the buffer partly written, where the
    library is absent or an item is not an int in [0, 2^256): the caller
    then serializes `vals` itself.  The caller vouches for `addr`: rows
    x 32 writable bytes."""
    lib = encode_lib()
    if lib is None:
        return False
    mod = None if p is None else (ctypes.c_uint64 * 4)(*_to_words(p))
    return lib.h2_encode_words(vals, rows, addr, mod) == 0


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
