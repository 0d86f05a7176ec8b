"""plonk_bench as plain data: halo2's prover benchmark circuit
(halo2_proofs/benches/plonk.rs), the StandardPlonk gadget over advice
a, b, c (equality on all three) and fixed sm, sa, sb, sc, one gate
a sa + b sb + a b sm - c sc = 0, with the minimum degree set to 5.

Each round is a raw_multiply row (a, a, a^2) with sa = sb = 0, sc = sm = 1,
then a raw_add row (a, a^2, a^2 + a) with sa = sb = sc = 1, sm = 0, and two
copies: a of the multiply row equals a of the add row, b of the add row c
of the multiply row.  The simple floor planner puts round i's rows at 2i
and 2i + 1.  The source proves one a for every round; here round i draws
its own a_i uniform over BN254's Fr from `random.Random(seed)`, so every
row holds full-width field elements.  No instance column, no lookup."""

from __future__ import annotations

import random

P = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
A, B, C = range(3)
SM, SA, SB, SC = range(4)


def rounds(rows: int) -> int:
    return rows // 2


def witness(k: int, rows: int, usable: int, seed: int) -> dict:
    """{"advice": {column: [value of rows 0, 1, ...]}, "instance": []}."""
    rng = random.Random(seed)
    a = [rng.randrange(P) for _ in range(rounds(rows))]
    sq = [x * x % P for x in a]
    fin = [(s + x) % P for s, x in zip(sq, a)]

    def rows_of(mul, add):
        col = [0] * (2 * len(mul))
        col[0::2], col[1::2] = mul, add
        return col
    return {"advice": {A: rows_of(a, a), B: rows_of(a, sq),
                       C: rows_of(sq, fin)},
            "instance": []}


def fixed_columns(k: int, rows: int, usable: int) -> list:
    """Per fixed column, {row: value}: sm on the multiply rows, sa and sb
    on the add rows, sc on both."""
    r = rounds(rows)
    mul = range(0, 2 * r, 2)
    add = range(1, 2 * r, 2)
    return [dict.fromkeys(mul, 1), dict.fromkeys(add, 1),
            dict.fromkeys(add, 1), dict.fromkeys(range(2 * r), 1)]


def copies(k: int, rows: int) -> list:
    """Each round: a0 = a1, then b1 = c0."""
    out = []
    for i in range(rounds(rows)):
        m, s = 2 * i, 2 * i + 1
        out += [(("advice", A, m), ("advice", A, s)),
                (("advice", B, s), ("advice", C, m))]
    return out


def lookup_columns(fixed: list, wit: dict) -> list:
    return []
