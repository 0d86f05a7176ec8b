"""The opening (commit/): the evaluations T15-23 and the multi-open
prover T24+, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["evals [T15-23]", "multiopen [T24+]"])
