"""lookup_heavy as plain data: four 16-bit range lookups a row into a
2^16-entry table, the gate acc = x0 + x1 * x2 on the rows that the fixed
column q marks, and x0[0] copied to the one public input.

The witness rule is the program's generator's (a copy of
`compat/lookup_heavy.py::lookup_heavy_instance`): x0..x3 uniform over
[0, 2^table_bits) from numpy's PCG64 seeded with the seed, acc = x0 + x1 x2,
which stays under 2^33, so no reduction is needed."""

from __future__ import annotations

import numpy as np

TABLE_BITS = 16
X_COLUMNS = 4          # advice 0..3; acc is advice 4


def table_bits(usable: int) -> int:
    return min(TABLE_BITS, (usable - 1).bit_length() - 1)


def witness(k: int, rows: int, usable: int, seed: int) -> dict:
    """{"advice": {column: int64 array of the first `rows` rows},
    "instance": [[public inputs of column 0]]}."""
    tb = table_bits(usable)
    g = np.random.Generator(np.random.PCG64(seed))
    xs = g.integers(0, 1 << tb, size=(X_COLUMNS, rows), dtype=np.int64)
    acc = xs[0] + xs[1] * xs[2]
    advice = {i: xs[i] for i in range(X_COLUMNS)}
    advice[X_COLUMNS] = acc
    return {"advice": advice, "instance": [[int(xs[0][0])]]}


def fixed_columns(k: int, rows: int, usable: int) -> list:
    """Per fixed column, {row: value}: q (column 0) is 1 on the active
    rows; the table (column 1) holds v at row v, and the rows after it
    repeat its first value, 0."""
    tb = table_bits(usable)
    return [dict.fromkeys(range(rows), 1),
            {v: v for v in range(1, 1 << tb)}]


def copies(k: int, rows: int) -> list:
    """x0 at row 0 equals the instance at row 0."""
    return [(("advice", 0, 0), ("instance", 0, 0))]


def lookup_columns(fixed: list, wit: dict) -> list:
    """Per lookup, the columns of its input and its table: their values
    over the usable rows are the multisets that the permuted columns
    hold."""
    return [(wit["advice"][i], fixed[1]) for i in range(X_COLUMNS)]
