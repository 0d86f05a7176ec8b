"""The advice commitments (the prover's commit_phase): the MSMs, their
normalisation and the transcript's writes, the `msms` and
`normalize+write` parts of step T3-4, seconds a proof."""

from ._steps import mean_of


def read(r):
    return mean_of(r, ["msms [T3-4]", "normalize+write [T3-4]"])
