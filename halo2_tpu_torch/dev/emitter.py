"""Failure-emitter rendering (port of the JAX reference's dev/emitter.py)
— halo2_frontend/src/dev/failure/emitter.rs.

Renders the aligned cell-layout tables and labeled constraint expressions
the reference prints for `ConstraintNotSatisfied` / `Lookup` failures
(failure.rs:442-487 render_constraint_not_satisfied, emitter.rs:38-205):

    Cell layout in region 'mul':
      | Offset | A0 | A1 |
      +--------+----+----+
      |    0   | x0 | x1 | <--{ Gate 'mul' applied here
      |    1   | x2 |    |

    Constraint 'mul constraint':
      S0 * (x0 * x1 - x2) = 0

    Assigned cell values:
      x0 = 2
      ...

Everything returns strings (the reference eprints); MockProver attaches the
rendered block to the failure's repr.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..frontend.expression import ADVICE, FIXED, INSTANCE
from . import metadata

# consensus column ordering (middleware circuit.rs:175-192):
# Instance < Advice < Fixed
_KIND_ORDER = {INSTANCE: 0, ADVICE: 1, FIXED: 2}
_KIND_LETTER = {ADVICE: "A", FIXED: "F", INSTANCE: "I"}


def format_value(p: int, v: int) -> str:
    """dev/util.rs:55-70: 0 / 1 / -1 / trimmed hex."""
    v %= p
    if v == 0:
        return "0"
    if v == 1:
        return "1"
    if v == p - 1:
        return "-1"
    return "0x" + format(v, "x")


def padded(pad_char: str, width: int, text: str) -> str:
    """emitter.rs:11-20 center padding (left-heavy)."""
    pad = max(width - len(text), 0)
    return pad_char * (pad - pad // 2) + text + pad_char * (pad // 2)


def column_type_and_idx(kind: str, index: int) -> str:
    return f"{_KIND_LETTER[kind]}{index}"


def _col_key(col: Tuple[str, int]):
    return (_KIND_ORDER[col[0]], col[1])


def render_cell_layout(prefix: str, location, columns: List[Tuple[str, int]],
                       layout: Dict[int, Dict[Tuple[str, int], str]],
                       highlight_row=None) -> str:
    """emitter.rs:38-141.  `columns` are (kind, index) pairs; `layout` maps
    rotation -> {column: label}.  `location` is a metadata.FailureLocation.
    `highlight_row(offset, rotation)` returns a trailing annotation."""
    cols = sorted(set(columns), key=_col_key)
    out = []
    if isinstance(location, metadata.InRegion):
        out.append(f"{prefix}Cell layout in region '{location.region.name}':")
        header = f"{prefix}  | Offset |"
        offset = location.offset
    else:
        row = location.row if location is not None else 0
        out.append(f"{prefix}Cell layout at row {row}:")
        header = f"{prefix}  |Rotation|"
        offset = None

    widths = [len(column_type_and_idx(*c)) + 3 for c in cols]
    line = header
    for c, w in zip(cols, widths):
        line += padded(" ", w, column_type_and_idx(*c)) + "|"
    out.append(line)
    sep = f"{prefix}  +--------+" + "".join(
        padded("-", w, "") + "+" for w in widths)
    out.append(sep)
    for rotation in sorted(layout):
        row_cells = layout[rotation]
        line = f"{prefix}  |" + padded(
            " ", 8, str((offset or 0) + rotation)) + "|"
        for c, w in zip(cols, widths):
            line += padded(" ", w, row_cells.get(c, "")) + "|"
        if highlight_row is not None:
            line += highlight_row(offset, rotation)
        out.append(line)
    return "\n".join(out)


def expression_to_string(expr, layout: Dict[int, Dict[Tuple[str, int], str]],
                         p: int) -> str:
    """emitter.rs:143-205: render the constraint with the layout's local
    variable labels (x0, x1, ...) substituted for queried cells."""

    def constant(v):
        return format_value(p, v)

    def selector(s):
        return f"S{s.index}"

    def query(column, rotation):
        label = layout.get(rotation.i, {}).get((column.kind, column.index))
        if label is not None:
            return label
        if column.kind == FIXED and rotation.i == 0:
            # most likely a merged selector (emitter.rs:169-172)
            return f"S{column.index}"
        return (f"{column_type_and_idx(column.kind, column.index)}"
                f"@{rotation.i}")

    def challenge(c):
        return f"Challenge({c.index})"

    return expr.evaluate(
        constant, selector, query, challenge,
        lambda a: f"-{a}",
        lambda a, b: f"{a} + {b}",
        lambda a, b: f"{a} * {b}",
        lambda a, k: f"{a} * {format_value(p, k)}")


def render_constraint_not_satisfied(p: int, constraint: metadata.Constraint,
                                    location, cell_values, expr) -> str:
    """failure.rs:442-487; returns the full multi-line block.
    cell_values: [(metadata.VirtualCell, int value)]."""
    columns: List[Tuple[str, int]] = []
    layout: Dict[int, Dict[Tuple[str, int], str]] = {}
    for i, (cell, _v) in enumerate(cell_values):
        col = (cell.column_kind, cell.column_index)
        columns.append(col)
        layout.setdefault(cell.rotation, {}).setdefault(col, f"x{i}")

    def highlight(offset, rotation):
        if rotation == 0:
            return f" <--{{ Gate '{constraint.gate.name}' applied here"
        return ""

    out = ["error: constraint not satisfied"]
    out.append(render_cell_layout("  ", location, columns, layout, highlight))
    out.append("")
    out.append(f"  Constraint '{constraint.name}':")
    out.append(f"    {expression_to_string(expr, layout, p)} = 0")
    out.append("")
    out.append("  Assigned cell values:")
    for i, (_cell, v) in enumerate(cell_values):
        out.append(f"    x{i} = {format_value(p, v)}")
    return "\n".join(out)


def render_lookup_failure(p: int, name: str, lookup_index: int, location,
                          input_exprs, input_values: List[int]) -> str:
    """failure.rs:489-560 analog for Lookup failures: show the lookup
    inputs as local variables with their values."""
    out = [f"error: lookup input does not exist in table",
           f"  (L{lookup_index}) ∉ (table)"]
    if isinstance(location, metadata.InRegion):
        out.append(f"  Lookup '{name}' inputs at {location.region} "
                   f"offset {location.offset}:")
    elif location is not None:
        out.append(f"  Lookup '{name}' inputs at row {location.row}:")
    for i, (e, v) in enumerate(zip(input_exprs, input_values)):
        out.append(f"    L{lookup_index}[{i}] = {format_value(p, v)}")
    return "\n".join(out)
