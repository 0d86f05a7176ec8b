"""The quotient (plonk/evaluation.py, poly/): evaluate_h T13 and the h
pieces' commitments T14, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["evaluate_h [T13]", "h_pieces [T14]"])
