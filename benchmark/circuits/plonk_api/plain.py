"""plonk_api as plain data: halo2's `plonk_api.rs` test circuit (the
`common!` macro): ten rounds of a*a = c and a + c = fin on a standard
PLONK gate over five advice columns, a public input gate, a 4-entry
lookup table, and copies a0 = a1, b1 = c0 each round.  Its witness is the
reference's (a = 2834758237 ZETA, public input 2) whatever the seed: the
seed draws the prover's blinding.

Rows (the simple floor planner, one row a region): the public input at
row 0, round i's multiply at 2i + 1 and its add at 2i + 2.  Columns:
advice e, a, b, c, d = 0..4; fixed sf, sm, sa, sb, sc, sp = 0..5 and the
table sl = 6; instance 0."""

from __future__ import annotations

P = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
ZETA = 0x12CCCA834ACDBA712CAAD5DC57AAB1B01D1F8BD237AD31491DAD5EBDFDFE4AB9
ROUNDS = 10
PUBLIC = 2
E, A, B, C, D = range(5)
SF, SM, SA, SB, SC, SP, SL = range(7)


def a_value() -> int:
    return 2834758237 * ZETA % P


def table() -> list:
    a = a_value()
    return [PUBLIC, a, a, 0]


def witness(k: int, rows: int, usable: int, seed: int) -> dict:
    """The advice columns as {column: [value of rows 0, 1, ...]} and the
    instance; the seed is the prover's, not the witness's."""
    a = a_value()
    sq = a * a % P
    fin = (sq + a) % P
    cols = {c: [0] * (2 * ROUNDS + 1) for c in range(5)}
    cols[A][0] = PUBLIC
    for i in range(ROUNDS):
        m, s = 2 * i + 1, 2 * i + 2
        for col, v in ((A, a), (B, a), (C, sq)):
            cols[col][m] = v
        for col, v in ((A, a), (B, sq), (C, fin)):
            cols[col][s] = v
        cols[D][m] = cols[D][s] = pow(a, 4, P)
        cols[E][m], cols[E][s] = pow(a, 4, P), pow(sq, 4, P)
    return {"advice": cols, "instance": [[PUBLIC]]}


def fixed_columns(k: int, rows: int, usable: int) -> list:
    """Per fixed column, {row: value}.  The table's unused rows up to the
    usable ones repeat its first value."""
    cols = [dict() for _ in range(7)]
    cols[SP][0] = 1
    for i in range(ROUNDS):
        m, s = 2 * i + 1, 2 * i + 2
        cols[SC][m] = cols[SC][s] = 1
        cols[SM][m] = 1
        cols[SA][s] = cols[SB][s] = 1
    t = table()
    cols[SL] = {row: (t[row] if row < len(t) else t[0])
                for row in range(usable)}
    return cols


def copies(k: int, rows: int) -> list:
    """Each round's copy region constrains a0 = a1 and b1 = c0, twice."""
    out = []
    for i in range(ROUNDS):
        m, s = 2 * i + 1, 2 * i + 2
        a0_a1 = (("advice", A, m), ("advice", A, s))
        b1_c0 = (("advice", B, s), ("advice", C, m))
        out += [a0_a1, a0_a1, b1_c0, b1_c0]
    return out


def lookup_columns(fixed: list, wit: dict) -> list:
    """The one lookup: column a into the table sl."""
    return [(wit["advice"][A], fixed[SL])]
