"""Rust-`Debug`-format renderer for the pinned verification key.

The reference hashes `format!("{:?}", vk.pinned())` (compact Debug) into the
transcript representative (halo2_backend/src/plonk.rs:189-202) and pins
`format!("{:#?}", vk.pinned())` (pretty Debug) as its strongest golden vector
(halo2_proofs/tests/plonk_api.rs:659-1141).  Byte-compatibility therefore
requires reproducing Rust's std `Debug` derive output *exactly* — including
the pretty-printer's 4-space indentation, trailing commas, and the manual
(non-derived) one-line `Debug` impls for field elements (`0x` + 64 lowercase
hex) and affine points (`(x, y)` on a single line).

This module builds a small Debug AST and renders it in both modes.  Struct
shapes mirror:
  - PinnedVerificationKey           halo2_backend/src/plonk.rs:246-254
  - PinnedEvaluationDomain          halo2_backend/src/poly/domain.rs:470-476
  - PinnedConstraintSystem (+Debug) halo2_backend/src/plonk/circuit.rs:241-286
  - QueryBack / VarBack / GateBack  halo2_backend/src/plonk/circuit.rs:9-55
  - ColumnMid / Any / ChallengeMid  halo2_middleware/src/circuit.rs:10-207
  - permutation::VerifyingKey       halo2_backend/src/plonk/permutation.rs
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..frontend.expression import (ADVICE, FIXED, INSTANCE, Column, Rotation)

_ANY_DEBUG = {ADVICE: "Advice", FIXED: "Fixed", INSTANCE: "Instance"}

_INDENT = "    "


# ----------------------------------------------------------------------
# Debug AST
# ----------------------------------------------------------------------

class D:
    __slots__ = ()


class DLeaf(D):
    """Pre-rendered single-line token (ints, field elems, points, None)."""
    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s


class DStr(D):
    """A Rust string rendered with Debug escaping (`"..."`)."""
    __slots__ = ("s",)

    def __init__(self, s: str):
        self.s = s


class DStruct(D):
    __slots__ = ("name", "fields")

    def __init__(self, name: str, fields: Sequence[Tuple[str, D]]):
        self.name = name
        self.fields = list(fields)


class DTuple(D):
    """Tuple struct / enum variant (`Name(a, b)`) or plain tuple (name='')."""
    __slots__ = ("name", "items")

    def __init__(self, name: str, items: Sequence[D]):
        self.name = name
        self.items = list(items)


class DList(D):
    __slots__ = ("items",)

    def __init__(self, items: Sequence[D]):
        self.items = list(items)


def _escape(s: str) -> str:
    # str::escape_debug for the simple strings that occur in pinned keys
    out = []
    for ch in s:
        if ch == "\\":
            out.append("\\\\")
        elif ch == '"':
            out.append('\\"')
        elif ch == "\n":
            out.append("\\n")
        elif ch == "\t":
            out.append("\\t")
        elif ch == "\r":
            out.append("\\r")
        else:
            out.append(ch)
    return "".join(out)


def render_compact(node: D) -> str:
    """`{:?}` — everything on one line, `, `-separated, spaces in braces."""
    if isinstance(node, DLeaf):
        return node.s
    if isinstance(node, DStr):
        return '"' + _escape(node.s) + '"'
    if isinstance(node, DStruct):
        if not node.fields:
            return node.name
        inner = ", ".join(f"{k}: {render_compact(v)}" for k, v in node.fields)
        return f"{node.name} {{ {inner} }}"
    if isinstance(node, DTuple):
        inner = ", ".join(render_compact(v) for v in node.items)
        return f"{node.name}({inner})"
    if isinstance(node, DList):
        return "[" + ", ".join(render_compact(v) for v in node.items) + "]"
    raise TypeError(node)


def render_pretty(node: D, level: int = 0) -> str:
    """`{:#?}` — Rust pretty Debug: 4-space indents, one entry per line,
    trailing commas; empty lists stay `[]`, empty structs stay bare names."""
    pad = _INDENT * level
    inner_pad = _INDENT * (level + 1)
    if isinstance(node, DLeaf):
        return node.s
    if isinstance(node, DStr):
        return '"' + _escape(node.s) + '"'
    if isinstance(node, DStruct):
        if not node.fields:
            return node.name
        lines = [f"{node.name} {{"]
        for k, v in node.fields:
            lines.append(f"{inner_pad}{k}: {render_pretty(v, level + 1)},")
        lines.append(f"{pad}}}")
        return "\n".join(lines)
    if isinstance(node, DTuple):
        if not node.items:
            return node.name if node.name else "()"
        lines = [f"{node.name}("]
        for v in node.items:
            lines.append(f"{inner_pad}{render_pretty(v, level + 1)},")
        lines.append(f"{pad})")
        return "\n".join(lines)
    if isinstance(node, DList):
        if not node.items:
            return "[]"
        lines = ["["]
        for v in node.items:
            lines.append(f"{inner_pad}{render_pretty(v, level + 1)},")
        lines.append(f"{pad}]")
        return "\n".join(lines)
    raise TypeError(node)


# ----------------------------------------------------------------------
# pinned-vk AST builders
# ----------------------------------------------------------------------

def _felt(v: int) -> DLeaf:
    """Field-element Debug: `0x` + 64 lowercase hex (manual impl in
    pasta_curves / halo2curves — single line in both modes)."""
    return DLeaf(f"0x{v:064x}")


def _point(pt: Optional[Tuple[int, int]]) -> DLeaf:
    """Affine point Debug: `(x, y)` one line (manual impl).  The identity
    never appears in a vk (commitments to nonzero polys); render the
    projective-identity form used by the curve crates if it ever does."""
    if pt is None:
        return DLeaf("(0x%064x, 0x%064x)" % (0, 1))
    x, y = pt
    return DLeaf(f"(0x{x:064x}, 0x{y:064x})")


def _rotation(r: Rotation) -> DTuple:
    return DTuple("Rotation", [DLeaf(str(r.i))])


def _column_mid(c: Column) -> DStruct:
    return DStruct("ColumnMid", [
        ("column_type", DLeaf(_ANY_DEBUG[c.kind])),
        ("index", DLeaf(str(c.index))),
    ])


def _query_tuple(q: Tuple[Column, Rotation]) -> DTuple:
    col, rot = q
    return DTuple("", [_column_mid(col), _rotation(rot)])


def expression_ast(expr, cs_back) -> D:
    """ExpressionBack Debug tree (backend circuit.rs:9-55).  Query indices
    come from the backend query map; frontend `scaled` lowers to
    Product(e, Constant) per expression.rs:507-509."""
    tag = expr.tag
    if tag == "const":
        return DTuple("Constant", [_felt(expr.value % cs_back.p)])
    if tag == "query":
        col, rot = expr.column, expr.rotation
        idx = cs_back.get_query_index(col, rot)
        qb = DStruct("QueryBack", [
            ("index", DLeaf(str(idx))),
            ("column_index", DLeaf(str(col.index))),
            ("column_type", DLeaf(_ANY_DEBUG[col.kind])),
            ("rotation", _rotation(rot)),
        ])
        return DTuple("Var", [DTuple("Query", [qb])])
    if tag == "challenge":
        ch = expr.value
        cm = DStruct("ChallengeMid", [
            ("index", DLeaf(str(ch.index))),
            ("phase", DLeaf(str(ch.phase))),
        ])
        return DTuple("Var", [DTuple("Challenge", [cm])])
    if tag == "neg":
        return DTuple("Negated", [expression_ast(expr.left, cs_back)])
    if tag == "sum":
        return DTuple("Sum", [expression_ast(expr.left, cs_back),
                              expression_ast(expr.right, cs_back)])
    if tag == "product":
        return DTuple("Product", [expression_ast(expr.left, cs_back),
                                  expression_ast(expr.right, cs_back)])
    if tag == "scaled":
        return DTuple("Product", [expression_ast(expr.left, cs_back),
                                  DTuple("Constant",
                                         [_felt(expr.value % cs_back.p)])])
    if tag == "selector":
        raise ValueError("selectors must be compressed away before keygen "
                         "(expression.rs:471 unreachable)")
    raise ValueError(f"unknown expression tag {tag}")


def pinned_vk_ast(vk) -> DStruct:
    """Build the PinnedVerificationKey Debug AST from a backend
    VerifyingKey (plonk/keygen.py)."""
    cs_back = vk.cs
    cs = cs_back.cs

    gates = DList([expression_ast(poly, cs_back)
                   for gate in cs.gates for poly in gate.polys])

    cs_fields: List[Tuple[str, D]] = [
        ("num_fixed_columns", DLeaf(str(cs.num_fixed_columns))),
        ("num_advice_columns", DLeaf(str(cs.num_advice_columns))),
        ("num_instance_columns", DLeaf(str(cs.num_instance_columns))),
    ]
    # Multi-phase fields only shown when challenges are in use
    # (circuit.rs:265-272).
    if cs.num_challenges > 0:
        cs_fields += [
            ("num_challenges", DLeaf(str(cs.num_challenges))),
            ("advice_column_phase",
             DList([DLeaf(str(p)) for p in cs.advice_column_phase])),
            ("challenge_phase",
             DList([DLeaf(str(p)) for p in cs.challenge_phase])),
        ]
    cs_fields += [
        ("gates", gates),
        ("advice_queries",
         DList([_query_tuple(q) for q in cs_back.advice_queries])),
        ("instance_queries",
         DList([_query_tuple(q) for q in cs_back.instance_queries])),
        ("fixed_queries",
         DList([_query_tuple(q) for q in cs_back.fixed_queries])),
        ("permutation", DStruct("ArgumentMid", [
            ("columns", DList([_column_mid(c)
                               for c in cs.permutation.columns])),
        ])),
        ("lookups", DList([
            DStruct("Argument", [
                ("name", DStr(lk.name)),
                ("input_expressions",
                 DList([expression_ast(e, cs_back)
                        for e in lk.input_expressions])),
                ("table_expressions",
                 DList([expression_ast(e, cs_back)
                        for e in lk.table_expressions])),
            ]) for lk in cs.lookups])),
    ]
    # shuffles field only shown when non-empty (circuit.rs:281-283)
    if cs.shuffles:
        cs_fields.append(("shuffles", DList([
            DStruct("Argument", [
                ("name", DStr(sh.name)),
                ("input_expressions",
                 DList([expression_ast(e, cs_back)
                        for e in sh.input_expressions])),
                ("shuffle_expressions",
                 DList([expression_ast(e, cs_back)
                        for e in sh.shuffle_expressions])),
            ]) for sh in cs.shuffles])))
    md = cs.minimum_degree
    cs_fields.append(("minimum_degree",
                      DLeaf("None") if md is None
                      else DTuple("Some", [DLeaf(str(md))])))

    return DStruct("PinnedVerificationKey", [
        ("base_modulus", DStr(f"0x{vk.curve.Fq.p:064x}")),
        ("scalar_modulus", DStr(f"0x{vk.F.p:064x}")),
        ("domain", DStruct("PinnedEvaluationDomain", [
            ("k", DLeaf(str(vk.domain.k))),
            ("extended_k", DLeaf(str(vk.domain.extended_k))),
            ("omega", _felt(vk.domain.omega)),
        ])),
        ("cs", DStruct("PinnedConstraintSystem", cs_fields)),
        ("fixed_commitments",
         DList([_point(pt) for pt in vk.fixed_commitments])),
        ("permutation", DStruct("VerifyingKey", [
            ("commitments",
             DList([_point(pt) for pt in vk.permutation.commitments])),
        ])),
    ])


def pinned_pretty(vk) -> str:
    """`format!("{:#?}", vk.pinned())` — the golden-vector form."""
    return render_pretty(pinned_vk_ast(vk))


def pinned_compact(vk) -> str:
    """`format!("{:?}", vk.pinned())` — the vk-hash preimage form."""
    return render_compact(pinned_vk_ast(vk))
