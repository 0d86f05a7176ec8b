"""A circuit's constraint system as plain data (a configuration file's
"shape"), with what a verifier derives from it: the query lists in halo2's
order, the blinding rows, the domain's sizes and the string that the
verifying key's hash is taken over.

An expression is a nested list:
  ["query", kind, column, rotation]   kind: "advice", "fixed", "instance"
  ["const", v]  ["neg", e]  ["sum", a, b]  ["product", a, b]  ["scaled", e, v]
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .curve import Curve

KINDS = ("advice", "fixed", "instance")
_DEBUG_KIND = {"advice": "Advice", "fixed": "Fixed", "instance": "Instance"}


def walk(expr, fn):
    """Calls fn(kind, column, rotation) for each query, left to right."""
    tag = expr[0]
    if tag == "query":
        fn(expr[1], expr[2], expr[3])
    elif tag in ("neg", "scaled"):
        walk(expr[1], fn)
    elif tag in ("sum", "product"):
        walk(expr[1], fn)
        walk(expr[2], fn)
    elif tag != "const":
        raise ValueError(f"unknown expression node {tag!r}")


def degree(expr) -> int:
    tag = expr[0]
    if tag == "query":
        return 1
    if tag == "const":
        return 0
    if tag in ("neg", "scaled"):
        return degree(expr[1])
    if tag == "sum":
        return max(degree(expr[1]), degree(expr[2]))
    return degree(expr[1]) + degree(expr[2])


def evaluate(expr, query, p: int) -> int:
    """The expression's value, query(kind, column, rotation) giving each
    query's."""
    tag = expr[0]
    if tag == "query":
        return query(expr[1], expr[2], expr[3])
    if tag == "const":
        return expr[1] % p
    if tag == "neg":
        return -evaluate(expr[1], query, p) % p
    if tag == "scaled":
        return evaluate(expr[1], query, p) * expr[2] % p
    a = evaluate(expr[1], query, p)
    b = evaluate(expr[2], query, p)
    return (a + b) % p if tag == "sum" else a * b % p


class Shape:
    """The "shape" object of a configuration file, and what follows from
    it for a domain of 2^k rows on `curve`'s scalar field."""

    def __init__(self, d: dict, k: int, curve: Curve):
        self.curve = curve
        self.k = k
        self.n = 1 << k
        self.num_advice = d["num_advice_columns"]
        self.num_fixed = d["num_fixed_columns"]
        self.num_instance = d["num_instance_columns"]
        self.gates: List[dict] = d["gates"]
        self.lookups: List[dict] = d["lookups"]
        self.permutation: List[Tuple[str, int]] = [
            (kind, col) for kind, col in d["permutation"]]
        self.minimum_degree = d.get("minimum_degree")
        if d.get("shuffles") or d.get("challenges"):
            raise ValueError("the plain verifier takes no shuffles and no "
                             "challenges")
        self.queries: Dict[str, List[Tuple[int, int]]] = {
            kind: [] for kind in KINDS}
        self._index: Dict[Tuple[str, int, int], int] = {}
        for gate in self.gates:
            for poly in gate["polys"]:
                walk(poly, self._add_query)
        for lk in self.lookups:
            for e in lk["input"] + lk["table"]:
                walk(e, self._add_query)
        for kind, col in self.permutation:
            self._add_query(kind, col, 0)
        self.degree = self._degree()
        per_column = [0] * self.num_advice
        for col, _rot in self.queries["advice"]:
            per_column[col] += 1
        self.blinding_factors = max(3, max(per_column + [1])) + 2
        self.usable_rows = self.n - (self.blinding_factors + 1)
        self.quotient_poly_degree = self.degree - 1
        ek = k
        while (1 << ek) < self.n * self.quotient_poly_degree:
            ek += 1
        self.extended_k = ek
        fr = curve.fr
        self.omega = pow(fr.root_of_unity, 1 << (fr.S - k), fr.p)
        self.chunk_len = self.degree - 2

    def _add_query(self, kind: str, col: int, rot: int):
        key = (kind, col, rot)
        if key not in self._index:
            self._index[key] = len(self.queries[kind])
            self.queries[kind].append((col, rot))

    def query_index(self, kind: str, col: int, rot: int) -> int:
        return self._index[(kind, col, rot)]

    def _degree(self) -> int:
        deg = 3                                   # the permutation argument
        for gate in self.gates:
            for poly in gate["polys"]:
                deg = max(deg, degree(poly))
        for lk in self.lookups:
            in_deg = max([1] + [degree(e) for e in lk["input"]])
            tb_deg = max([1] + [degree(e) for e in lk["table"]])
            deg = max(deg, 4, 2 + in_deg + tb_deg)
        if self.minimum_degree is not None:
            deg = max(deg, self.minimum_degree)
        return deg

    def as_data(self) -> dict:
        """What a configuration file declares, to set beside the program's
        own constraint system."""
        return {
            "num_advice_columns": self.num_advice,
            "num_fixed_columns": self.num_fixed,
            "num_instance_columns": self.num_instance,
            "gates": [g["polys"] for g in self.gates],
            "lookups": [[lk["name"], lk["input"], lk["table"]]
                        for lk in self.lookups],
            "permutation": [list(c) for c in self.permutation],
            "advice_queries": [list(q) for q in self.queries["advice"]],
            "fixed_queries": [list(q) for q in self.queries["fixed"]],
            "instance_queries": [list(q) for q in self.queries["instance"]],
            "degree": self.degree,
            "blinding_factors": self.blinding_factors,
            "extended_k": self.extended_k,
        }

    # -- the pinned verifying key, as Rust's `{:?}` prints it ------------

    def _expr_debug(self, e) -> str:
        tag = e[0]
        if tag == "query":
            kind, col, rot = e[1], e[2], e[3]
            return (f"Var(Query(QueryBack {{ index: "
                    f"{self.query_index(kind, col, rot)}, column_index: "
                    f"{col}, column_type: {_DEBUG_KIND[kind]}, rotation: "
                    f"Rotation({rot}) }}))")
        if tag == "const":
            return f"Constant(0x{e[1] % self.curve.r:064x})"
        if tag == "neg":
            return f"Negated({self._expr_debug(e[1])})"
        if tag == "scaled":
            return (f"Product({self._expr_debug(e[1])}, "
                    f"Constant(0x{e[2] % self.curve.r:064x}))")
        name = "Sum" if tag == "sum" else "Product"
        return f"{name}({self._expr_debug(e[1])}, {self._expr_debug(e[2])})"

    @staticmethod
    def _column_debug(kind: str, col: int) -> str:
        return f"ColumnMid {{ column_type: {_DEBUG_KIND[kind]}, index: {col} }}"

    def pinned(self, fixed_commitments, permutation_commitments) -> str:
        """`format!("{:?}", vk.pinned())` of halo2's PinnedVerificationKey."""
        def point(pt):
            return f"(0x{pt[0]:064x}, 0x{pt[1]:064x})"

        def queries(kind):
            return "[" + ", ".join(
                f"({self._column_debug(kind, c)}, Rotation({r}))"
                for c, r in self.queries[kind]) + "]"

        gates = ", ".join(self._expr_debug(poly) for g in self.gates
                          for poly in g["polys"])
        lookups = ", ".join(
            f'Argument {{ name: "{lk["name"]}", input_expressions: ['
            + ", ".join(self._expr_debug(e) for e in lk["input"])
            + "], table_expressions: ["
            + ", ".join(self._expr_debug(e) for e in lk["table"]) + "] }"
            for lk in self.lookups)
        perm = ", ".join(self._column_debug(k, c) for k, c in self.permutation)
        md = ("None" if self.minimum_degree is None
              else f"Some({self.minimum_degree})")
        cs = (f"PinnedConstraintSystem {{ num_fixed_columns: {self.num_fixed}"
              f", num_advice_columns: {self.num_advice}, "
              f"num_instance_columns: {self.num_instance}, gates: [{gates}], "
              f"advice_queries: {queries('advice')}, instance_queries: "
              f"{queries('instance')}, fixed_queries: {queries('fixed')}, "
              f"permutation: ArgumentMid {{ columns: [{perm}] }}, lookups: "
              f"[{lookups}], minimum_degree: {md} }}")
        return (f'PinnedVerificationKey {{ base_modulus: '
                f'"0x{self.curve.q:064x}", scalar_modulus: '
                f'"0x{self.curve.r:064x}", domain: '
                f"PinnedEvaluationDomain {{ k: {self.k}, extended_k: "
                f"{self.extended_k}, omega: 0x{self.omega:064x} }}, cs: {cs}, "
                f"fixed_commitments: ["
                + ", ".join(point(p) for p in fixed_commitments)
                + "], permutation: VerifyingKey { commitments: ["
                + ", ".join(point(p) for p in permutation_commitments)
                + "] } }")
