"""Witness synthesis and the advice commitments (frontend/, the prover's
commit_phase): step T3-4 of the step table, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["witness+advice_commits [T3-4]"])
