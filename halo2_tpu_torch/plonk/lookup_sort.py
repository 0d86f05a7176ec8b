"""Sort-based `permute_expression_pair` (port of
the JAX reference's plonk/lookup_sort.py; lookup/prover.rs:410-494).

  A' = sorted(input)
  S'[i] = A'[i]                  where A'[i] is a first occurrence
        = leftover_desc[rank(i)] on repeated rows: the table multiset minus
                                 one copy of each distinct input value,
                                 ascending, filled into repeated rows in
                                 DESCENDING row order (the reference's
                                 BTreeMap / rows-popped-from-the-end rule)

Values compare as canonical 256-bit integers.  PyTorch has no multi-key
sort, so the reference's stable `lax.sort(num_keys=8/9)` becomes stable
least-significant-key-first `torch.sort(stable=True)` passes, which give
the same order, ties included.
"""

from __future__ import annotations

import torch

from ..fields.field import NWORDS, Field


def _lex_order(keys):
    """Stable lexicographic argsort; keys most significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _word_keys(words):
    """(n, 8) int32 canonical words -> 8 int64 keys, most significant first."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    return [w[:, NWORDS - 1 - i] for i in range(NWORDS)]


def permute_expression_pair_device(F: Field, comp_in, comp_tab, usable: int):
    """(A', S') over the first `usable` rows, Montgomery words; raises
    ValueError when an input value is missing from the table."""
    a = F.from_mont(comp_in[:usable])
    t = F.from_mont(comp_tab[:usable])
    dev = a.device

    ai = a[_lex_order(_word_keys(a))]
    unique = torch.ones(usable, dtype=torch.bool, device=dev)
    unique[1:] = (ai[1:] != ai[:-1]).any(dim=1)
    ti = t[_lex_order(_word_keys(t))]

    # merged order: first-occurrence inputs (tag 0) and table entries
    # (tag 1), stable by (value, tag); repeated inputs are inert (tag 3)
    merged = torch.cat([ai, ti])
    tags = torch.cat([torch.where(unique, 0, 3),
                      torch.ones(usable, dtype=torch.int64, device=dev)])
    order = _lex_order(_word_keys(merged) + [tags])
    m_words, m_tags = merged[order], tags[order]

    # a table entry is used iff its predecessor is an equal tag-0 entry; a
    # tag-0 entry not followed by an equal table entry is missing
    eq_next = torch.zeros(2 * usable, dtype=torch.bool, device=dev)
    eq_next[:-1] = (m_words[1:] == m_words[:-1]).all(dim=1)
    next_tags = torch.full_like(m_tags, 255)
    next_tags[:-1] = m_tags[1:]
    if bool(((m_tags == 0) & ~(eq_next & (next_tags == 1))).any()):
        raise ValueError("lookup input not in table")
    used_here = torch.zeros_like(eq_next)
    used_here[1:] = (m_tags[1:] == 1) & (m_tags[:-1] == 0) & eq_next[:-1]

    # used flags back in sorted-table order, then unused entries ascending
    used = torch.zeros_like(used_here)
    used[order] = used_here
    used_tab = used[usable:]
    leftover = ti[torch.sort(used_tab.to(torch.int64), stable=True).indices]

    n_rep = usable - int(unique.sum())
    rank = torch.cumsum((~unique).to(torch.int64), 0) - 1
    take = (n_rep - 1 - rank).clamp(0, usable - 1)
    s_words = torch.where(unique[:, None], ai, leftover[take])
    return F.to_mont(ai), F.to_mont(s_words)
