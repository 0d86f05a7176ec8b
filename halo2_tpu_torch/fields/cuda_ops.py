"""Kernel A (csrc/field.cu): elementwise field mul / add / sub, its plain
PyTorch version, and the int64 limb arithmetic every plain version uses.

Replaces the JAX reference's fields/pallas_ops.py (`_binop_pallas`,
`_binop_pallas_lm`).  Elements are (..., 8) int32 tensors holding the u32
bit patterns of the Montgomery value.  The wrapper takes the plain version
only for a tensor on the CPU; for a CUDA tensor it launches the kernel.

The plain versions compute in int64 16-bit limbs: torch's CPU uint32 lacks
add, shift and compare, and `>>` on int32 is arithmetic.  A limb product is
< 2^32 and a column of 16 of them < 2^36, so every intermediate stays far
inside int64; the column sums are float64 matrix products, exact because
every partial sum is an integer below 2^53.

Small CPU batches take the same formulas over python ints instead; the one
rule that picks between the two is `on_ints` below, used by kernel A's and
kernel B's plain versions (and so by every plain version built on them).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as nnf

from .._build import I32, I64, P, Kernel, stream_of

MUL, ADD, SUB = 0, 1, 2
NWORDS = 8
NLIMBS = 16
MASK = 0xFFFF
_PLAIN_CHUNK = 1 << 16      # elements per plain-version step on big inputs

# The plain versions' one selection rule.  Their int64-limb code is the
# plain PyTorch version that the card's kernels are held against; a CPU batch
# of at most INT_ELEMS field elements (kernel A) or INT_POINTS points (kernel
# B) runs the same formulas over python ints, because at that size the limbs
# are bound by the overhead of their many small tensor ops.  Both give the
# canonical residue, so the output words are equal; the CPU tests run every
# plain-version case on both sides of the rule.
INT_ELEMS = 1 << 10
INT_POINTS = 1 << 11

_binop_kernel = Kernel("h2_field_binop", [I32, I32, P, P, P, I64, P])


def on_ints(t: torch.Tensor, points: bool = False) -> bool:
    """True where a plain version computes over python ints (see
    INT_ELEMS): t holds (..., 8) field elements or (..., 3, 8) points."""
    if t.device.type != "cpu":
        return False
    if points:
        return t.numel() <= 3 * NWORDS * INT_POINTS
    return t.numel() <= NWORDS * INT_ELEMS


# ----------------------------------------------------------------------
# word <-> limb conversion
# ----------------------------------------------------------------------

def to_limbs(w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 words -> (..., 16) int64 16-bit limbs."""
    w = w.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & MASK, w >> 16], dim=-1).flatten(-2)


def to_words(l: torch.Tensor) -> torch.Tensor:
    """(..., 16) int64 limbs in [0, 2^16) -> (..., 8) int32 words."""
    w = l[..., 0::2] | (l[..., 1::2] << 16)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def int_to_limbs(x: int) -> list:
    return [(x >> (16 * i)) & MASK for i in range(NLIMBS)]


def ints(w: torch.Tensor) -> list:
    """CPU (..., 8) int32 words -> flat list of python ints."""
    b = w.contiguous().numpy().tobytes()
    return [int.from_bytes(b[i:i + 32], "little")
            for i in range(0, len(b), 32)]


def words(vals, shape) -> torch.Tensor:
    """python ints < 2^256 -> CPU int32 words of `shape`."""
    buf = b"".join(v.to_bytes(32, "little") for v in vals)
    return torch.from_numpy(np.frombuffer(buf, np.int32).copy()).reshape(shape)


# ----------------------------------------------------------------------
# int64 limb arithmetic
# ----------------------------------------------------------------------

def _norm(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate limbs of any sign and size so that every limb but the
    top lies in [0, 2^16); the top limb keeps the rest (value unchanged)."""
    while True:
        c = t[..., :-1] >> 16
        if not bool(c.any()):
            return t
        t = torch.cat([t[..., :-1] & MASK, t[..., -1:]], dim=-1)
        t[..., 1:] += c


def _norm_mod(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate modulo 2^(16 L): the carry out of the top is dropped."""
    while True:
        c = t >> 16
        if not bool(c[..., :-1].any()):
            return t & MASK
        t = t & MASK
        t[..., 1:] += c[..., :-1]


def _toeplitz(c: list, cols: int, device) -> torch.Tensor:
    """(16, cols) float64 matrix M with M[i, i + j] = c[j]: x @ M is the
    limb convolution of x with the constant limbs c."""
    m = torch.zeros(NLIMBS, cols, dtype=torch.float64)
    for i in range(NLIMBS):
        for j, cj in enumerate(c):
            if i + j < cols:
                m[i, i + j] = cj
    return m.to(device)


def _mm(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Exact integer x @ m in float64: every product is below 2^32 and every
    column sums at most 256 of them, far inside float64's 53 bits."""
    return (x.to(torch.float64) @ m).to(torch.int64)


class Limbs:
    """Modular arithmetic on canonical (..., 16) int64 limb tensors for one
    field on one device — the plain versions of kernels A-D."""

    def __init__(self, F, device):
        self.F = F
        p_limbs = int_to_limbs(F.p)
        self.p17 = torch.tensor(p_limbs + [0], dtype=torch.int64,
                                device=device)
        self.p_mat = _toeplitz(p_limbs, 31, device)
        nprime = (-pow(F.p, -1, 1 << 256)) % (1 << 256)
        self.nprime_mat = _toeplitz(int_to_limbs(nprime), NLIMBS, device)
        # column sums of the outer product: pair (i, j) lands in column i+j
        diag = torch.zeros(NLIMBS * NLIMBS, 31, dtype=torch.float64)
        for i in range(NLIMBS):
            for j in range(NLIMBS):
                diag[i * NLIMBS + j, i + j] = 1
        self.diag = diag.to(device)

    def _cond_sub(self, r17):
        """r17: (..., 17) normalized value < 2p -> canonical (..., 16)."""
        d = _norm(r17 - self.p17)
        return torch.where(d[..., -1:] >= 0, d[..., :NLIMBS],
                           r17[..., :NLIMBS])

    def mul(self, a, b):
        """Montgomery product a b 2^-256 mod p."""
        outer = a.unsqueeze(-1) * b.unsqueeze(-2)           # < 2^32
        t = _mm(outer.flatten(-2), self.diag)               # (..., 31) < 2^36
        m = _norm_mod(_mm(_norm_mod(t[..., :NLIMBS]), self.nprime_mat))
        u = _norm(nnf.pad(t + _mm(m, self.p_mat), (0, 2)))  # low half = 0
        return self._cond_sub(u[..., NLIMBS:])

    def add(self, a, b):
        return self._cond_sub(_norm(nnf.pad(a + b, (0, 1))))

    def sub(self, a, b):
        d = _norm(nnf.pad(a - b, (0, 1)))
        f = _norm(d + self.p17)
        return torch.where(d[..., -1:] < 0, f, d)[..., :NLIMBS]

    def mul_b3(self, x, b3: int):
        """x * 3b by the reference's chains: 9x = 8x + x (BN254 G1) and
        15x = 16x - x (Pasta)."""
        x2 = self.add(x, x)
        x4 = self.add(x2, x2)
        x8 = self.add(x4, x4)
        if b3 == 9:
            return self.add(x8, x)
        assert b3 == 15, f"no addition chain for b3 = {b3}"
        return self.sub(self.add(x8, x8), x)


_LIMBS: dict = {}


def limbs_for(F, device) -> Limbs:
    key = (F.p, str(device))
    lf = _LIMBS.get(key)
    if lf is None:
        lf = _LIMBS[key] = Limbs(F, device)
    return lf


def chunked(fn, n: int, *arrays, chunk: int = _PLAIN_CHUNK):
    """Apply fn over the leading axis in chunks (bounds the int64 transient
    of the plain versions on large inputs)."""
    if n <= chunk:
        return fn(*arrays)
    return torch.cat([fn(*[a[i:i + chunk] for a in arrays])
                      for i in range(0, n, chunk)], dim=0)


# ----------------------------------------------------------------------
# kernel A
# ----------------------------------------------------------------------

def _binop_ints(F, mode: int, a, b):
    p = F.p
    x, y = ints(a), ints(b)
    if mode == MUL:
        r = F.R_inv
        out = [u * v * r % p for u, v in zip(x, y)]
    elif mode == ADD:
        out = [(u + v) % p for u, v in zip(x, y)]
    else:
        out = [(u - v) % p for u, v in zip(x, y)]
    return words(out, a.shape)


def binop_plain(F, mode: int, a, b):
    """Plain PyTorch version of kernel A on broadcast (..., 8) words."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    if on_ints(a):
        return _binop_ints(F, mode, a, b)
    L = limbs_for(F, a.device)
    op = (L.mul, L.add, L.sub)[mode]

    def run(x, y):
        return to_words(op(to_limbs(x), to_limbs(y)))

    n = 1
    for d in shape[:-1]:
        n *= d
    out = chunked(run, n, a.reshape(n, NWORDS), b.reshape(n, NWORDS))
    return out.reshape(shape)


def binop(F, mode: int, a, b):
    """mode MUL / ADD / SUB of broadcast (..., 8) int32 field elements."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu":
        return binop_plain(F, mode, a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"field op on unsupported devices {a.device}, "
                         f"{b.device}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 or \
            a.shape[-1] != NWORDS:
        raise ValueError(f"field op needs (..., 8) int32, got {a.dtype} "
                         f"{tuple(a.shape)}")
    a = a.contiguous()
    b = b.contiguous()
    out = torch.empty_like(a)
    _binop_kernel.launch(mode, F.kernel_id, a.data_ptr(), b.data_ptr(),
                         out.data_ptr(), out.numel() // NWORDS,
                         stream_of(out))
    return out
