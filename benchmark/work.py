"""The work one proof needs in the NTT and MSM layers, counted from the
configuration's declared shape and the benchmark's own inputs, as the
algorithm needs it and not as a kernel happens to do it.

NTT: a transform of n elements needs (n/2) log2 n Montgomery products and
reads and writes 32 n bytes each way.  A proof makes, per column:
lagrange_to_coeff at 2^k of every instance, advice, permuted lookup
(input and table), lookup product and permutation product column;
coeff_to_extended at 2^extended_k of the same columns, for the quotient;
one extended_to_coeff at 2^extended_k, of h.

MSM: for an MSM of n points the nonzero balanced signed digits of its
scalars at the window c = auto_c(n) (each a mixed addition, 11 products:
Renes-Costello-Batina alg. 8 with b3 by additions), plus per window the
bucket reduction, 2 * 2^(c-1) full additions (12 products, alg. 7), and the
windows' combination, c doublings (8 products, alg. 9) and one addition a
window.  It reads 32 bytes of scalar and 64 of affine point a term.  The
scalars the benchmark knows are counted digit by digit: the instance and
advice columns, and the permuted lookup columns, which hold the multisets
of the lookup's input and table columns.  The blinding rows and the derived
columns (grand products, the random polynomial, the h pieces, the
multi-open's own) count as dense: every window nonzero.  The scheme says
which dense MSMs its multi-open makes."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from . import peaks

MADD_PRODUCTS = 11
ADD_PRODUCTS = 12
DOUBLE_PRODUCTS = 8
MSM_BYTES_PER_TERM = 32 + 64
SCALAR_BITS = {"bn254": 254, "vesta": 255, "pallas": 255}


def auto_c(n: int) -> int:
    """The window of the reference's sorted MSM (c = 13 from 2^17 points)."""
    return max(4, min(13, int(n).bit_length() - 4))


def n_windows(c: int, curve: str) -> int:
    """Balanced digits: c * windows >= bits + 2, so the top digit absorbs
    the last carry."""
    return -(-(SCALAR_BITS[curve] + 2) // c)


def nonzero_digits(values, c: int, windows: int) -> int:
    """Nonzero balanced base-2^c digits (each in [-2^(c-1), 2^(c-1)]) of
    non-negative scalars, summed: in numpy for an array below 2^62, on
    python ints for anything else."""
    if isinstance(values, np.ndarray) and values.dtype == np.int64 and (
            not values.size or (values.min() >= 0
                                and values.max() < 1 << 62)):
        return _digits_numpy(values, c, windows)
    return sum(_digits_int(int(v), c, windows) for v in values)


def _digits_int(v: int, c: int, windows: int) -> int:
    half, mask, count, carry = 1 << (c - 1), (1 << c) - 1, 0, 0
    for w in range(windows):
        d = ((v >> (c * w)) & mask) + carry
        carry = 1 if d > half else 0
        count += (d - (carry << c)) != 0
    return count


def _digits_numpy(v: np.ndarray, c: int, windows: int) -> int:
    mask, half = (1 << c) - 1, 1 << (c - 1)
    carry = np.zeros_like(v)
    total = 0
    for w in range(windows):
        d = ((v >> (c * w)) & mask) + carry if c * w < 63 else carry
        carry = (d > half).astype(np.int64)
        d = d - (carry << c)
        total += int(np.count_nonzero(d))
    return total


def ntt_products(log_n: int) -> int:
    return (1 << (log_n - 1)) * log_n


def ntt_bytes(log_n: int) -> int:
    return 2 * 32 * (1 << log_n)


@dataclass
class LayerWork:
    """Least seconds of one proof's work in a layer, and what bounds it."""
    seconds: float = 0.0
    bounds: Dict[str, float] = field(default_factory=dict)
    items: List[str] = field(default_factory=list)

    def add(self, products: float, nbytes: float, curve: str, what: str):
        t, bound = peaks.least_seconds(products, nbytes, curve)
        self.seconds += t
        self.bounds[bound] = self.bounds.get(bound, 0.0) + t
        self.items.append(what)

    def bound(self) -> str:
        return max(self.bounds, key=self.bounds.get) if self.bounds else ""


def ntt_work(shape, curve: str) -> LayerWork:
    """One proof's transforms, from the shape."""
    columns = (shape.num_instance + shape.num_advice
               + 3 * len(shape.lookups)
               + -(-len(shape.permutation) // shape.chunk_len))
    w = LayerWork()
    k, ek = shape.k, shape.extended_k
    for _ in range(columns):
        w.add(ntt_products(k), ntt_bytes(k), curve, f"lagrange_to_coeff 2^{k}")
        w.add(ntt_products(ek), ntt_bytes(ek), curve,
              f"coeff_to_extended 2^{ek}")
    w.add(ntt_products(ek), ntt_bytes(ek), curve, f"extended_to_coeff 2^{ek}")
    return w


def _msm(w: LayerWork, n: int, digits: int, curve: str, what: str):
    c = auto_c(n)
    windows = n_windows(c, curve)
    products = (digits * MADD_PRODUCTS
                + windows * (2 * (1 << (c - 1)) * ADD_PRODUCTS
                             + c * DOUBLE_PRODUCTS + ADD_PRODUCTS))
    w.add(products, n * MSM_BYTES_PER_TERM, curve, what)


def msm_work(shape, curve: str, advice: Dict[int, list], lookup_columns,
             dense_sizes: List[int], instance=None) -> LayerWork:
    """One proof's MSMs: the instance columns where the scheme commits
    them (their values), the advice columns (their witness rows, then
    zeros, then the blinding rows), two permuted columns a lookup (the
    multisets of its input and table columns over the usable rows, then
    the blinding rows), each of n points, and the dense MSMs of
    `dense_sizes` points."""
    n = shape.n
    c = auto_c(n)
    windows = n_windows(c, curve)
    blind_digits = (n - shape.usable_rows) * windows
    w = LayerWork()
    for i, col in enumerate(instance or []):
        _msm(w, n, nonzero_digits(col, c, windows), curve, f"instance {i}")
    for col in range(shape.num_advice):
        vals = advice.get(col, np.zeros(0, np.int64))
        _msm(w, n, nonzero_digits(vals, c, windows) + blind_digits, curve,
             f"advice {col}")
    for li, (inp, table) in enumerate(lookup_columns):
        for name, vals in (("input", inp), ("table", list(table.values()))):
            if name == "table" and all(v < 1 << 62 for v in vals):
                vals = np.array(vals, np.int64)
            _msm(w, n, nonzero_digits(vals, c, windows) + blind_digits,
                 curve, f"lookup {li} permuted {name}")
    for i, size in enumerate(dense_sizes):
        cs = auto_c(size)
        _msm(w, size, size * n_windows(cs, curve), curve, f"dense {i}")
    return w


def derived_commitments(shape) -> int:
    """The dense n-point commitments every proof makes: a product a
    lookup, a product a permutation set, the random polynomial and the h
    pieces."""
    return (len(shape.lookups) + -(-len(shape.permutation) // shape.chunk_len)
            + 1 + shape.quotient_poly_degree)
