"""Prime-field arithmetic on PyTorch tensors (port of the JAX reference's fields/field.py).

An element is an (..., 8) int32 tensor: the u32 bit patterns of the
Montgomery value a * 2^256 mod p, little-endian words, canonical (< p).
R = 2^256 is the reference's R, so one element is the reference's 16
u16-limbs packed two per word (`compat/from_jax.py` converts).

Every operation is elementwise over arbitrary leading dimensions and runs
where its input lies: add / sub / mul go through kernel A
(`fields/cuda_ops.py`), everything else is composed from them.  Tensors are
created on the device the caller names; constants are built on the CPU and
moved with `.to(device)` once per device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..trace import to_host
from . import cuda_ops
from .cuda_ops import ADD, MUL, NWORDS, SUB

INV_BLOCK = 16      # rows per level of the blocked batch inversion


def _words_tensor(vals, device) -> torch.Tensor:
    """python ints < 2^256 -> (n, 8) int32 words (no Montgomery map)."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(buf, dtype="<u4").view(np.int32).reshape(-1, NWORDS)
    return torch.from_numpy(arr.copy()).to(device)


class Field:
    """A prime field with per-device constants and batched tensor ops.

    The host-side constants mirror the reference's `Field` (ROOT_OF_UNITY,
    DELTA, ZETA, TWO_INV, S).  `kernel_id` names the modulus in the CUDA
    sources (0 BN254 Fr, 1 BN254 Fq, 2 Pasta Fp, 3 Pasta Fq)."""

    def __init__(self, name: str, modulus: int, generator: int,
                 zeta: int = None, kernel_id: int = None):
        assert modulus < (1 << 255)
        self.name = name
        self.p = modulus
        self.generator = generator
        self.kernel_id = kernel_id
        t = modulus - 1
        s = 0
        while t % 2 == 0:
            t //= 2
            s += 1
        self.S = s
        self.t_odd = t
        self.root_of_unity = pow(generator, t, modulus)
        self.root_of_unity_inv = pow(self.root_of_unity, modulus - 2, modulus)
        self.delta = pow(generator, 1 << s, modulus)
        self.two_inv = pow(2, modulus - 2, modulus)
        if zeta is not None:
            assert zeta != 1 and pow(zeta, 3, modulus) == 1
            self.zeta = zeta
        elif (modulus - 1) % 3 == 0:
            self.zeta = pow(generator, (modulus - 1) // 3, modulus)
        else:
            self.zeta = None
        self.R = (1 << 256) % modulus
        self.R2 = (self.R * self.R) % modulus
        self.R_inv = pow(self.R, modulus - 2, modulus)
        self._consts: dict = {}

    # ------------------------------------------------------------------
    # constants per device
    # ------------------------------------------------------------------

    def _const(self, key: str, device) -> torch.Tensor:
        """(8,) int32 words of a fixed value, cached per device."""
        ck = (key, str(device))
        c = self._consts.get(ck)
        if c is None:
            val = {"one": self.R, "r2": self.R2, "canon_one": 1}[key]
            c = self._consts[ck] = _words_tensor([val], device).reshape(
                NWORDS)
        return c

    # ------------------------------------------------------------------
    # host conversions
    # ------------------------------------------------------------------

    def to_mont_int(self, x: int) -> int:
        return (x * self.R) % self.p

    def from_mont_int(self, x: int) -> int:
        return (x * self.R_inv) % self.p

    def encode_ints(self, xs, device) -> torch.Tensor:
        """Canonical python ints -> (n, 8) Montgomery words on `device`
        (bytes on the host, the Montgomery map on the device)."""
        vals = [int(x) % self.p for x in np.asarray(xs, dtype=object).ravel()]
        if not vals:
            return torch.zeros((0, NWORDS), dtype=torch.int32, device=device)
        return self.to_mont(_words_tensor(vals, device))

    def encode_ints_cols(self, cols, device) -> torch.Tensor:
        """m equal-length columns of python ints -> (m, n, 8), one host
        serialization and one to-Montgomery dispatch."""
        m = len(cols)
        if m == 0:
            return torch.zeros((0, 0, NWORDS), dtype=torch.int32,
                               device=device)
        n = len(cols[0])
        p = self.p
        words = _words_tensor([v % p for col in cols for v in col], device)
        return self.to_mont(words).reshape(m, n, NWORDS)

    def encode_int(self, x: int, device) -> torch.Tensor:
        return _words_tensor([self.to_mont_int(int(x) % self.p)],
                             device).reshape(NWORDS)

    def words_to_ints(self, arr) -> list:
        """Raw (..., 8) words -> python ints (no Montgomery map); from a
        card, one read that waits for it (`trace.to_host`)."""
        a = to_host(arr.detach()).contiguous().numpy().astype(np.int32)
        buf = a.view("<u4").tobytes()
        return [int.from_bytes(buf[i:i + 32], "little")
                for i in range(0, len(buf), 32)]

    def decode_ints(self, arr) -> list:
        """Montgomery (..., 8) -> canonical python ints (flattened)."""
        if arr.numel() == 0:
            return []
        return self.words_to_ints(self.from_mont(arr))

    def decode_int(self, arr) -> int:
        return self.decode_ints(arr)[0]

    def to_repr(self, x: int) -> bytes:
        return int(x % self.p).to_bytes(32, "little")

    def from_repr(self, b: bytes) -> int:
        x = int.from_bytes(b, "little")
        if x >= self.p:
            raise ValueError(f"non-canonical field repr for {self.name}")
        return x

    def from_uniform_bytes(self, b: bytes) -> int:
        assert len(b) == 64
        return int.from_bytes(b, "little") % self.p

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------

    def zeros(self, shape, device) -> torch.Tensor:
        return torch.zeros(tuple(shape) + (NWORDS,), dtype=torch.int32,
                           device=device)

    def ones(self, shape, device) -> torch.Tensor:
        return self._const("one", device).expand(
            tuple(shape) + (NWORDS,)).clone()

    def full(self, shape, x: int, device) -> torch.Tensor:
        return self.encode_int(x, device).expand(
            tuple(shape) + (NWORDS,)).clone()

    # ------------------------------------------------------------------
    # arithmetic (kernel A and compositions of it)
    # ------------------------------------------------------------------

    def add(self, a, b):
        return cuda_ops.binop(self, ADD, a, b)

    def sub(self, a, b):
        return cuda_ops.binop(self, SUB, a, b)

    def mul(self, a, b):
        """Montgomery product a b R^-1 mod p, broadcast over leading dims."""
        return cuda_ops.binop(self, MUL, a, b)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def square(self, a):
        return self.mul(a, a)

    def mul_pow2(self, a, k: int):
        """a 2^k by k doublings (small k only)."""
        for _ in range(k):
            a = self.add(a, a)
        return a

    def to_mont(self, a_canonical):
        return self.mul(a_canonical, self._const("r2", a_canonical.device))

    def from_mont(self, a_mont):
        return self.mul(a_mont, self._const("canon_one", a_mont.device))

    def pow(self, a, e: int):
        """a^e for a python-int exponent (square and multiply)."""
        e = int(e) % (self.p - 1) if e >= self.p - 1 else int(e)
        acc = self.ones(a.shape[:-1], a.device)
        base = a
        while e:
            if e & 1:
                acc = self.mul(acc, base)
            e >>= 1
            if e:
                base = self.square(base)
        return acc

    def inv(self, a):
        """Inverse via Fermat; 0 maps to 0."""
        return self.pow(a, self.p - 2)

    def prefix_product(self, a):
        """Inclusive running product along axis 0 (Hillis-Steele doubling:
        log n rounds of one batched multiply)."""
        n = a.shape[0]
        d = 1
        while d < n:
            head = self.ones((d,) + tuple(a.shape[1:-1]), a.device)
            a = self.mul(a, torch.cat([head, a[:-d]], dim=0))
            d *= 2
        return a

    def batch_inv(self, a, axis: int = 0):
        """Inverse of every element along `axis` with one field inversion;
        zeros stay zero."""
        a = a.movedim(axis, 0)
        is_zero = self.is_zero(a)
        safe = torch.where(is_zero[..., None],
                           self.ones(a.shape[:-1], a.device), a)
        inv = self._inv_nonzero(safe)
        inv = torch.where(is_zero[..., None], torch.zeros_like(inv), inv)
        return inv.movedim(0, axis)

    def _inv_nonzero(self, a):
        """Inverses of nonzero a along axis 0 by Montgomery's trick in
        blocks: a is read as INV_BLOCK rows of n / INV_BLOCK columns; running
        products go down the rows (one batched multiply per row), the column
        totals are inverted the same way, and the inverses walk back up.
        About 3n multiplies in all, against n log n for a doubling scan."""
        n = a.shape[0]
        if n == 1:
            return self.inv(a)
        r = min(n, INV_BLOCK)
        pad = (-n) % r
        if pad:
            a = torch.cat([a, self.ones((pad,) + a.shape[1:-1], a.device)])
        x = a.reshape((r, a.shape[0] // r) + a.shape[1:])
        pre = [x[0]]
        for i in range(1, r):
            pre.append(self.mul(pre[-1], x[i]))
        acc = self._inv_nonzero(pre[-1])
        out = [None] * r
        for i in range(r - 1, 0, -1):
            out[i] = self.mul(acc, pre[i - 1])
            acc = self.mul(acc, x[i])
        out[0] = acc
        return torch.stack(out).reshape(a.shape)[:n]

    # ------------------------------------------------------------------
    # predicates
    # ------------------------------------------------------------------

    def eq(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return (a == b).all(dim=-1)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def select(self, cond, a, b):
        """cond ? a : b elementwise, cond shaped like the batch dims."""
        cond = torch.as_tensor(cond, device=a.device)
        return torch.where(cond[..., None], a, b)

    def rand_ints(self, n: int, rng) -> list:
        """n canonical elements drawn from `rng` (a random.Random)."""
        return [rng.randrange(self.p) for _ in range(n)]

    def __repr__(self):
        return f"Field({self.name})"

    def __hash__(self):
        return hash((self.name, self.p))

    def __eq__(self, other):
        return isinstance(other, Field) and other.p == self.p
