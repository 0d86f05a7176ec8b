"""Expression evaluation over column tensors (port of
halo2_tpu/plonk/evaluation.py): rotations become `torch.roll`, sums and
products batched field ops over whole columns."""

from __future__ import annotations

import torch

from halo2_tpu.frontend.expression import ADVICE, FIXED, INSTANCE

from ..fields.field import Field


def evaluate_expression(F: Field, expr, *, fixed, advice, instance,
                        challenges, device, rot_scale: int = 1):
    """Evaluate `expr` over every row.  fixed / advice / instance:
    (num_cols, rows, 8) tensors; challenges: {index: encoded (8,)};
    rot_scale: rows per unit rotation (2^(extended_k - k) on the extended
    domain).  Returns (rows, 8) (or a broadcastable (8,) for constants)."""
    kind_map = {FIXED: fixed, ADVICE: advice, INSTANCE: instance}

    def selector_fn(s):
        raise AssertionError(
            "selectors must be converted to fixed columns before evaluation")

    def query_fn(column, rotation):
        col = kind_map[column.kind][column.index]
        return torch.roll(col, -rotation.i * rot_scale, dims=0)

    return expr.evaluate(
        lambda v: F.encode_int(v, device), selector_fn, query_fn,
        lambda c: challenges[c.index], F.neg, F.add, F.mul,
        lambda a, k: F.mul(a, F.encode_int(k, device)))
