"""The verifying key, worked out again from plain data: the fixed columns'
and the permutation's commitments, and the key's hash.  The commitments
are the scheme's (`kzg_key` here, `ipa.ipa_key`); the permutation's
mapping and the hash are common."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .curve import batch_inv, inv
from .shape import Shape

Cell = Tuple[int, int]          # (permutation column, row)


@dataclass
class VerifyingKey:
    fixed_commitments: list
    permutation_commitments: list
    transcript_repr: int = 0
    extra: dict = field(default_factory=dict)   # the scheme's own data

    def hash(self, shape: Shape):
        """Blake2b of the pinned key's `{:?}` string (halo2 plonk.rs),
        personalised "Halo2-Verify-Key", length-prefixed."""
        pinned = shape.pinned(self.fixed_commitments,
                              self.permutation_commitments).encode()
        h = hashlib.blake2b(digest_size=64, person=b"Halo2-Verify-Key")
        h.update(len(pinned).to_bytes(8, "little"))
        h.update(pinned)
        self.transcript_repr = int.from_bytes(h.digest(), "little") % \
            shape.curve.r
        return self


def permutation_moves(shape: Shape, copies) -> Dict[Cell, Cell]:
    """The cells whose sigma is not themselves, and where each maps.
    Cycles are merged as halo2's keygen merges them (permutation/
    keygen.rs), the smaller into the larger, so that the mapping, and so
    each sigma, is the prover's."""
    col_of = {c: j for j, c in enumerate(shape.permutation)}
    mapping: Dict[Cell, Cell] = {}
    aux: Dict[Cell, Cell] = {}
    sizes: Dict[Cell, int] = {}
    for (lk, lc, lr), (rk, rc, rr) in copies:
        left = (col_of[(lk, lc)], lr)
        right = (col_of[(rk, rc)], rr)
        left_cycle = aux.get(left, left)
        right_cycle = aux.get(right, right)
        if left_cycle == right_cycle:
            continue
        if sizes.get(left_cycle, 1) < sizes.get(right_cycle, 1):
            left_cycle, right_cycle = right_cycle, left_cycle
        sizes[left_cycle] = sizes.get(left_cycle, 1) + \
            sizes.get(right_cycle, 1)
        i = right_cycle
        while True:
            aux[i] = left_cycle
            i = mapping.get(i, i)
            if i == right_cycle:
                break
        lm = mapping.get(left, left)
        mapping[left] = mapping.get(right, right)
        mapping[right] = lm
    return {c: t for c, t in mapping.items() if c != t}


def sigma_corrections(shape: Shape, copies) -> List[Dict[int, int]]:
    """Per permutation column j, {row: sigma_j(omega^row) - delta^j
    omega^row} at the cells copies move; sigma_j(omega^i) = delta^j'
    omega^i' for (j, i) -> (j', i'), and every other cell maps to
    itself."""
    r = shape.curve.r
    delta = shape.curve.fr.delta
    out: List[Dict[int, int]] = [{} for _ in shape.permutation]
    for (cj, row), (tj, trow) in permutation_moves(shape, copies).items():
        out[cj][row] = (pow(delta, tj, r) * pow(shape.omega, trow, r)
                        - pow(delta, cj, r) * pow(shape.omega, row, r)) % r
    return out


class LagrangeAtS:
    """L_i(s) = omega^i (s^n - 1) / (n (s - omega^i)) for the rows a
    column uses."""

    def __init__(self, shape: Shape, s: int):
        self.shape = shape
        r = shape.curve.r
        self.s = s % r
        self.common = (pow(self.s, shape.n, r) - 1) * inv(shape.n, r) % r

    def combine(self, column: Dict[int, int]) -> int:
        """sum_i v_i L_i(s) over a column given as {row: value}."""
        r = self.shape.curve.r
        omega = self.shape.omega
        rows = sorted(row for row, v in column.items() if v % r)
        pows, last_row, last = [], None, 1
        for row in rows:            # rows ascend: step from the last one
            step = row - last_row if last_row is not None else None
            last = last * pow(omega, step, r) % r if step is not None \
                and step < 64 else pow(omega, row, r)
            last_row = row
            pows.append(last)
        invs = batch_inv([(self.s - w) % r for w in pows], r)
        return sum(column[row] * (self.common * w % r * i % r)
                   for row, w, i in zip(rows, pows, invs)) % r


def kzg_key(shape: Shape, s: int, fixed_columns, copies) -> VerifyingKey:
    """KZG with a known trapdoor s ([s^i]G; the benchmark makes it from a
    fixed seed): a column of values v_i commits to (sum_i v_i L_i(s)) G,
    field arithmetic and one scalar multiplication where the prover runs
    an MSM.  Since sum_i omega^i L_i(s) = s, sigma_j commits to delta^j s
    plus its corrections."""
    curve = shape.curve
    r = curve.r
    lag = LagrangeAtS(shape, s)
    fixed = [curve.mul(curve.gen, lag.combine(fixed_columns[j]))
             for j in range(shape.num_fixed)]
    perm = [curve.mul(curve.gen, (pow(curve.fr.delta, j, r) * lag.s
                                  + lag.combine(fix)) % r)
            for j, fix in enumerate(sigma_corrections(shape, copies))]
    return VerifyingKey(fixed, perm, extra={"s": lag.s}).hash(shape)
