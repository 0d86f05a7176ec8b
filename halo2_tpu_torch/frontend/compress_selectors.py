"""Degree-budgeted selector compression.

Behavioral parity with halo2_frontend/src/plonk/circuit/compress_selectors.rs
(`process`, :51-228) and the `ConstraintSystem::compress_selectors` entry point
(constraint_system.rs:595-659): simple selectors whose activations are
mutually exclusive are packed into shared fixed "combination" columns, with
each selector substituted by an interpolation polynomial that is non-zero
exactly on the rows carrying its assigned root.

Everything here is deterministic — combination order is the selector
registration order, which feeds the pinned-vk hash.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Tuple

from .expression import Expression


@dataclass
class SelectorDescription:
    """compress_selectors.rs:5-18."""
    selector: int                 # index of the selector being described
    activations: List[bool]       # per-row activation bitmap
    max_degree: int               # max degree of any gate using it (incl. the
                                  # virtual selector itself); 0 for complex /
                                  # unused selectors


@dataclass
class SelectorAssignment:
    """compress_selectors.rs:20-32."""
    selector: int
    combination_index: int
    expression: Expression        # substitute for the virtual selector


def process(selectors: List[SelectorDescription], max_degree: int,
            allocate_fixed_column: Callable[[], Expression],
            ) -> Tuple[List[List[int]], List[SelectorAssignment]]:
    """Pack selectors into combination columns (compress_selectors.rs:51-228).

    `allocate_fixed_column` must allocate a fresh fixed column and return its
    Rotation(0) query expression.  Returns the per-combination column value
    lists (small-int field values 0..=combination_len) and the substitution
    list.  Deterministic.
    """
    if not selectors:
        return [], []

    n = len(selectors[0].activations)
    assert all(len(s.activations) == n for s in selectors)

    combination_assignments: List[List[int]] = []
    selector_assignments: List[SelectorAssignment] = []

    # Degree-0 selectors (complex, or appearing in no gate) each get their own
    # plain 0/1 fixed column, substituted by the bare query.
    simple: List[SelectorDescription] = []
    for desc in selectors:
        if desc.max_degree == 0:
            expression = allocate_fixed_column()
            combination_index = len(combination_assignments)
            combination_assignments.append(
                [1 if b else 0 for b in desc.activations])
            selector_assignments.append(SelectorAssignment(
                desc.selector, combination_index, expression))
        else:
            simple.append(desc)

    # Exclusion matrix: conflict[i][j] (j<i) iff selectors i and j are both
    # enabled on some row — they can't share a combination column.
    conflict = [[False] * i for i in range(len(simple))]
    for i, desc in enumerate(simple):
        for j in range(i):
            other = simple[j].activations
            if any(l and r for l, r in zip(desc.activations, other)):
                conflict[i][j] = True

    added = [False] * len(simple)
    for i, desc in enumerate(simple):
        if added[i]:
            continue
        added[i] = True
        assert desc.max_degree <= max_degree
        # Track the largest gate degree in the combination, minus one for the
        # virtual selector itself (it is substituted with our expression).
        d = desc.max_degree - 1
        combination = [desc]
        members = [i]

        for j in range(i + 1, len(simple)):
            if d + len(combination) == max_degree:
                break  # combination is full: nothing more can fit
            if added[j]:
                continue
            if any(conflict[j][m] if m < j else conflict[m][j]
                   for m in members):
                continue
            cand = simple[j]
            new_d = max(d, cand.max_degree - 1)
            # adding one selector raises the substitution degree by one
            if new_d + len(combination) + 1 > max_degree:
                continue
            d = new_d
            combination.append(cand)
            members.append(j)
            added[j] = True

        # Emit the combination column: selector #t (1-based root) writes root
        # value t on its active rows; disjointness guarantees no overwrite.
        combination_assignment = [0] * n
        combination_len = len(combination)
        combination_index = len(combination_assignments)
        query = allocate_fixed_column()

        for root_1based, member in enumerate(combination, start=1):
            # substitution: q * Prod[w in 1..=len, w != root](w - q),
            # non-zero exactly where the column holds `root`
            # (compress_selectors.rs:184-200).
            expression = query
            for w in range(1, combination_len + 1):
                if w != root_1based:
                    expression = expression * (Expression.const(w) - query)
            for row, active in enumerate(member.activations):
                if active:
                    combination_assignment[row] = root_1based
            selector_assignments.append(SelectorAssignment(
                member.selector, combination_index, expression))
        combination_assignments.append(combination_assignment)

    return combination_assignments, selector_assignments
